#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demiurge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA;
2. builds the CUDA kernels from csrc/ (one nvcc per source, sm_90a) and
   prints the time;
3. the ocean kernels at 2048x1024 (the ocean CLI's terrain: fBm, 8 octaves,
   seed 7, and a (u, v) after one ocean step through the plain twins), each
   against its plain PyTorch twin on the card, timed with CUDA events:
   pressure Jacobi (200 and 1000 sweeps) and viscosity Jacobi (50 sweeps),
   bit for bit, with their launches and K11e's time on the same solves,
   and both once more at 8192x4096 (the same terrain recipe and a (u, v)
   after one plain ocean step), bit for bit, with the tiered advect sampler
   there (atol 1e-5); the sampler at 2048x1024 (atol 1e-5) and, at
   2048x1000 (H not a whole number of 32-row strips), the same kernel with
   a one-row table (K4b, atol 1e-5); the fused advect stage (K4's stage
   form) against its twin, the torch ops around the plain tap sum, at
   2048x1024, 8192x4096 and 2048x1000 (the one-row table): within 1e-6
   of max|u| with NaN and inf where the twin's are, the count of
   differing values printed; the fused kernels timed on the device with
   their launches queued ahead of the host (``tools.timing.device_ms``);
   the projection kernel (K13) against ``ocean.project`` at 8192x4096 and
   2048x1024 (``tools.project_race``, the CLI's terrain and a step's
   projection inputs): bit for bit, timed on the device beside the twin
   and the stage's 24-byte bounds, 0.240 and 0.015 ms;
4. the ocean path with every launch counter at 0: the ``ocean`` CLI (1 step
   at --jacobi 1000, 5 at --jacobi 200, 1 at 2048x1000, which takes the
   one-row table) and 5 ``ocean_step``s at the coupled model's solver
   depths; fails unless its kernels launched, the advect stage and the
   projection ran as one fused launch each a step, the fields are
   finite, the CLI logged ``advect_clamped``, and the kernel path's
   (u, v) match the same 5 steps through the plain twins (1e-5 of
   max|u|);
5. the coupled step's kernels at 2048x1024 (the same terrain, and a state
   after one coupled step through the plain twins), each against its twin:
   the band kernels K1 (climate, 10 substeps) and K5 (blur, radius 0.5)
   bit for bit there and at 8192x4096, and K1 over a climate dispatch
   (250 substeps) at 4096x2048, NaNs and infs where the twin's are, each
   with its launches (at most 2 a coupled step, 32 a dispatch), bands and
   CUDA-event time; directions (ties at most 1 per 10^4 pixels); the
   packed directions (K6's packed form: its codes against the plain twin,
   ties at most 1 per 10^4 pixels, its packed masks exactly pack_masks of
   its codes and their mouths) there, on a 2000x1000 grid and at
   8192x4096; the flow
   A fixpoint (K7) cold and warm (bit for bit) and vis (K8, exact), each
   with its rounds, host reads and tile visits, and both on a serpentine
   river (32 columns x 200 rows over the dateline) and on a 2000x1000 grid
   that the tiles do not divide;
6. the coupled path with every launch counter at 0: the ``coupled`` CLI at
   2048x1024 for 3 steps and at its default 8192x4096 for 1 step, and the
   ``climate`` CLI at its default 4096x2048 for 500 substeps; prints K1's
   and K5's launches a run (fails above 2 a coupled step or 32 a climate
   dispatch); fails unless every kernel of the step launched, the advect
   and the directions + masks ran as one fused launch each a step, and
   every
   logged number and field of the coupled runs is finite.  The climate
   run's grid is past the reference model's stability bound on land
   (explicit substep, a = D dt / C > 1/8), where the reference diverges
   too; that run is held to the same 500 substeps through the plain
   twins, NaNs included;
7. 5 ``coupled_step``s at 2048x1024 on the kernels (host clock, ms per
   step) against the same 5 through the plain twins: u, v and T within
   1e-5 of max, the height beyond 1e-5 of max at no more than 1e-3 of the
   pixels; and a per-stage device profile of one step (CUDA events; the
   rows sum to the step; the climate's insolation table and heat-capacity
   build apart from K1, the ocean's coefficient builds apart from the
   Jacobi sweeps; each kernel form's launches in the row), and
   torch.profiler's count of device kernels in one step;
8. the sharded path on a 1x1 mesh, in this process, in a world-size-1
   NCCL group: the two-level flow kernels (K10a cold with exit ids and
   warm without, K10b with a zero and a nonzero seed) on the coupled
   path's masks at 2048x1024 (band 128), at 2000x1000 (band 8) and at
   8192x4096 (band 128), each bit for bit against its twin, with its
   rounds, host reads and tile visits, and timed beside K7 and K8 on the
   same masks; ``flow_solve_twolevel``
   at 2048x1024 and 8192x4096 against K7's A (rtol 1e-5, atol 1e-7), and
   both sharded flow solves on the mesh against K7 and K8 (same bound, vis
   exact), each timed beside K7; then, with every launch counter at 0, 3
   ``coupled_step(mesh=1x1)``s against 3 single-card steps (height rtol
   1e-5 atol 1e-6, T rtol 1e-5 atol 1e-4, u and v rtol 1e-5 atol 1e-6),
   ms per step, fails unless K5 and K6's codes form launched on the row
   strips and K10a and K10b launched, or if a ``sharded_call`` or a
   full-field gather ran (``dist.mesh``'s traffic counters); a per-stage
   device profile of one mesh step (the local stages of ``dist.local``);
   then each local stage on that step's inputs bit for bit against the
   single-card stage, timed beside it and beside the ``sharded_call``
   form; K5 and K6's codes form on the strip bit for bit against their
   plain forms there (0 ties); the overlapped halo sweeps (pressure, 25
   rounds of 8; viscosity, 5 of 10) bit for bit against the monolithic
   ones, timed; one mesh step at 8192x4096 (finite, its peak memory, no
   field gathered); ``coupled --mesh 1x1`` through
   ``torch.distributed.run`` (2 steps at 2048x1024): finite logs and K10
   launches; ``tools.scaling_bench`` at one rank (2048x1024, 5 steps) and
   its refusal of more ranks than cards;
8c. the mesh cases that once ran on the gathered fields, each through its
   entry point on the 1x1 mesh with every launch counter at 0: an
   ``exact_quirks`` coupled step at 2048x1024, a warm-started pressure
   solve at 2048x1024 (the 200 sweeps from the previous step's pressure),
   a coupled step on a 2048x1024 grid whose latitudes stop short of both
   poles (land in its three edge rows on each side: there the halo rounds
   read zeros beyond the edge, as the reference's do, where the single
   card clamps), and a 250-substep climate dispatch on a 2048x128 grid,
   its row strip shallower than the dispatch; each prints its
   ``sharded_call``s and field gathers and fails unless both are 0, and
   is held to the same single-card call at phase 8's bounds (the
   pressure within 2e-5 of max|p|, the mesh tests' bound), its ms beside
   the single card's (CUDA events, 1 call after a warm-up);
9. the reference's alternative flow solvers and the packed Jacobi (K11):
   ``tools.flow_rounds`` at 2048x1024 as a subprocess (must exit 0 and
   report K11d launches); then, with every launch counter at 0,
   ``tools.flow_tune``'s run in this process at 2048x1024 (on the flow
   masks after 10 coupled steps: K11a-d each bit for bit against its
   twin, A bit for bit against K7, the wave within rtol 1e-5, atol 1e-7,
   vis equal to K8, each timed beside K7+K8) and the packed Jacobi (K11e,
   8 sweeps a launch on shared-memory tiles) at the coupled depths (200
   pressure sweeps, 50 viscosity sweeps on u and v: 25 + 7 launches),
   bit for bit against its twin (and 61 sweeps, the remainder launch) and
   within phase 3's bounds of K2 and K3, timed beside them and beside its
   earlier one-launch-a-sweep design (the yardstick); K11b (one
   persistent launch on K7/K8's tiles, one host read a solve) in modes
   "both", "A" and "vis" against its twin, K7 and K8 (A bit for bit, vis
   exact) on flow_tune's masks, on the CLI's terrain at 2000x1000 and at
   8192x4096, with its rounds, tile visits, launches and host reads,
   "both" timed beside its earlier design (band windows, the yardstick)
   and K7+K8; at 8192x4096 also K7+K8 with their rounds and tile visits,
   and K11a-d against them without twins, one call each; the redesigned
   K11a (one persistent launch, TMA windows) and K11c (the wave blocked
   in time on tiles that skip where it died, K8's vis beside it) at
   2048x1024, 2000x1000 and 8192x4096 against their twins (K11a's on the
   card's tiles), K7 (K11a's A) and K8 (both vis) bit for bit, one launch
   and one host read a solve, K11c's wave tile-sweeps beside the twin's
   sweeps x tiles, each timed beside its earlier design and K7+K8;
10. BASELINE config 1 with every launch counter at 0: the ``erosion`` CLI
   at its default 1024x512 for 5 steps (the full flow filter with lakes,
   then the erosion pass); fails unless K5 and K6's codes form launched
   once a step (and the packed form never), K12's tiled solve (the
   lake-aware relaxation: its A, vis and root kernels) in every step,
   each as many rounds as its solve reports, the one-sweep kernel never,
   the native lake solver ran once a step, and every logged mass and the
   field are finite; held to the same 5 iterations through the plain
   twins (the height beyond 1e-5 of max at no more than 1e-3 of the
   pixels, direction ties counted); then 5 iterations written out stage
   by stage (equal to the CLI's field), each stage timed on the host
   clock around a synchronize: pre-blur + directions + masks, the host
   lake solve with its copies, the lake-aware relaxation (K12's tiles)
   with its launches and host reads, the flow map + erosion pass; then
   K12 on the first iteration's inputs, on the same inputs without
   connections, on a 2000x1000 grid and on a regional 300x12 grid (the
   CLI's terrain on both): the tiled solve bit for bit against the twin's
   solve (A; vis and root exact) with its rounds, launches, host reads
   and tile visits, the one-sweep kernel against the twin after 1, 7 and
   64 sweeps and over its own solve with the same sweeps; the three
   solves timed with CUDA events, and each tiled kernel's solve alone;
10b. BASELINE config 2 with every launch counter at 0: the
   ``tectonic-erosion`` CLI at its default 2048x1024 for 6 steps (the
   tectonic uplift refreshed at steps 0 and 5, then phase 10's iteration);
   the same checks and twin bound as phase 10, 6 native lake solves; then
   the 6 iterations stage by stage (equal to the CLI's field), the
   tectonic uplift timed in the iterations that run it, K12 on the first
   iteration's inputs as in phase 10 (its rows in the kernels line: the
   three tiled kernels and the one-sweep kernel), and torch.profiler's
   count of device kernels in one tectonic step;
12. the editor session (``api.Project``) at 2048x1024, the size of
   BASELINE configs 2, 3 and 5, with every launch counter at 0: ridged
   fBm (make_planet's parameters), the six other modes into layers, a
   brush stroke across the dateline near the north pole, the selection
   tools, blur, thermal erosion, morphology, offset and scale, DeTerrace
   on the terrain quantised to steps of 0.25, the flow map and its undo,
   2 erosion iterations, an ocean step with Jacobi and one with CG, 10
   climate substeps, 2 tectonics steps, the PNG export and the npz save;
   each step timed on the host clock around a synchronize.  Fails unless
   K1, K2, K3, K4's stage form, K5, K6's codes form and K12's three
   tiled kernels launched (the one-sweep K12 never), every field is
   finite, the npz loads back exactly, the same session through
   the plain twins matches step by step (within 1e-5 of max before the
   flow map, beyond it at no more than 1e-3 of the pixels; direction
   ties counted), undoing everything returns the terrain to 0 and the
   selection to 1 and redoing everything returns the final terrain,
   within the snapshot codec's accumulated accuracy; prints the undo
   bytes and each step's device kernels (torch.profiler, on a replay
   without the flow steps);
13. render, checkpoints and the examples, with every launch counter at 0
   before each counted run: phase 12's final session rendered at its
   2048x1024 into 2048x1024 through every layer (the arrows on the
   session's currents) in every projection, Goode with interrupted lobes
   and the orthographic globe after a drag, each timed with CUDA events
   and held to the same render on the host (a differing pixel must lie at
   a texel edge within the measured |ds|, |dt|, on the rim, or on a texel
   the chain renders apart, those at most 1e-3 of the texels); the
   ``coupled`` CLI at 2048x1024, 3 steps with --png and 2 steps with a
   checkpoint every 2 resumed to 3 (the resumed state against the
   uninterrupted one: bit for bit or how far; within phase 7's twin
   bounds), each save and load timed; ``coupled --mesh 1x1`` with a
   checkpoint, resumed, held to the single-card run at phase 8's bounds,
   and ``save_sharded``/``load_sharded`` round-tripped on the NCCL mesh;
   both examples as subprocesses at their published defaults (in the
   background from the renders on; exit 0 and the PNG's size). Fails
   unless K1-K8 launched in the CLI runs and K5, K6 and K10 on the mesh;
   prints the phase's time;
11. prints the kernels' JSON line (each kernel form's own launches on the
   path that runs it: the stage and packed forms are not counted again
   under the sampler and codes forms; K5, K6's codes form and K12's
   tiled kernels count the erosion and tectonic-erosion runs, K1-K6 and
   K12's tiled kernels the editor session (the one-sweep K12 0 on every
   path), and
   every kernel phase 13's CLI runs and phase 8c's cases launched; K11b's
   and K11e's earlier
   designs, the yardsticks, 0 on every path),
   the card line and, last, the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the exit code is non-zero.  Without a card, or
without the package beside this script, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
W, H = 2048, 1024
SEED = 7
DEVICE = "cuda"
BIG = (8192, 4096)      # the coupled CLI's default size
RAGGED = (2000, 1000)   # a grid K7/K8's 16x128 tiles do not divide
HB = H - 24             # K4b's grid height: not a whole number of strips
CLIMATE = (4096, 2048)  # the climate CLI's default size
ERODE = (1024, 512)     # the erosion CLI's default size (BASELINE config 1)
TECTO = (2048, 1024)    # the tectonic-erosion CLI's (BASELINE config 2)
REGIONAL = (-1.0, 0.9, -2.5, 1.0)  # a regional grid's coords (no wrap)

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
    from demiurge_tpu_torch.kernels import flow_deadends as kx
    from demiurge_tpu_torch.kernels import jacobi as kj
    from demiurge_tpu_torch.kernels import jacobi_packed as kp
    from demiurge_tpu_torch.kernels import lakeflow as kl
    from demiurge_tpu_torch.kernels import project as kpr
    from demiurge_tpu_torch.ops import blur as ob
    from demiurge_tpu_torch.ops import erosion, ocean, temperature
    from demiurge_tpu_torch.ops import flow as of
    from demiurge_tpu_torch.tools import flow_tune as ft
    from demiurge_tpu_torch.tools import flow_inputs, serpentine
    from demiurge_tpu_torch.tools import project_race
    from demiurge_tpu_torch.tools.timing import device_ms

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
                "flow_local_vis": (k2, "LAUNCHES_LOCAL_VIS"),
                "advect_sample_pallas": (ka, "LAUNCHES_ONE_ROW"),
                "flow_solve_2d": (kx, "LAUNCHES_2D"),
                "flow_solve_2d_tma": (kx, "LAUNCHES_2D_TMA"),
                "flow_solve_fused": (kx, "LAUNCHES_FUSED"),
                "flow_solve_wave": (kx, "LAUNCHES_WAVE"),
                "flow_solve_wave_tiles": (kx, "LAUNCHES_WAVE_TILES"),
                "flow_banded_rounds": (kx, "LAUNCHES_BANDED"),
                "flow_banded_sweeps": (kx, "LAUNCHES_BANDED_SWEEPS"),
                "jacobi_packed": (kp, "LAUNCHES"),
                "jacobi_packed_sweeps": (kp, "LAUNCHES_SWEEPS"),
                "flow_solve_fused_bands": (kx, "LAUNCHES_FUSED_BANDS"),
                "advect_stage": (ka, "LAUNCHES_STAGE"),
                "advect_stage_one_row": (ka, "LAUNCHES_STAGE_ONE_ROW"),
                "flow_directions_packed": (kd, "LAUNCHES_PACKED"),
                "blur_strip": (kb, "LAUNCHES_STRIP"),
                "flow_directions_strip": (kd, "LAUNCHES_STRIP"),
                "lake_relax": (kl, "LAUNCHES"),
                "lake_area_tiles": (kl, "LAUNCHES_AREA_TILES"),
                "lake_vis_tiles": (kl, "LAUNCHES_VIS_TILES"),
                "lake_root_tiles": (kl, "LAUNCHES_ROOT_TILES"),
                "ocean_project": (kpr, "LAUNCHES")}
    # K12's tiled solve: its three kernels, one for each field
    lake_tiles = ["lake_area_tiles", "lake_vis_tiles", "lake_root_tiles"]
    # the kernels of the single-card coupled path; the mesh path's are
    # phase 8's, the one-row table's phase 4's, K11's phase 9's
    single_card = ["jacobi_pressure", "jacobi_diffusion", "climate", "blur",
                   "flow_solve", "flow_vis", "advect_stage",
                   "flow_directions_packed", "ocean_project"]

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts(names):
        return {n: getattr(*counters[n]) for n in names}

    def own_forms(c):
        """Each form's own launches from every counter's reading: the
        sampler's and the codes form's counters (LAUNCHES,
        LAUNCHES_ONE_ROW) count the stage and packed forms' launches too,
        the stage's counts its one-row launches, and K5's and the codes
        form's count their launches on a rank's row strip."""
        c = dict(c)
        c["advect_sample_pallas"] -= c["advect_stage_one_row"]
        c["advect_sample_tiered"] -= (c["advect_stage"]
                                      + c["advect_sample_pallas"])
        c["advect_stage"] -= c["advect_stage_one_row"]
        c["flow_directions"] -= (c["flow_directions_packed"]
                                 + c["flow_directions_strip"])
        c["blur"] -= c["blur_strip"]
        return c

    @contextlib.contextmanager
    def plain_twins():
        """Every op with every kernel swapped for its plain twin."""
        swaps = [(kj, "pressure_solve", kj.pressure_solve_plain),
                 (kj, "diffusion_solve", kj.diffusion_solve_plain),
                 (ka, "advect_sample", ka.advect_sample_tiered_plain),
                 (ka, "advect_stage", ka.advect_stage_plain),
                 (kpr, "project_stage", ocean.project),
                 (kc, "climate_step", kc.climate_step_plain),
                 (kb, "blur", kb.blur_plain),
                 (kd, "flow_directions", kd.flow_directions_plain),
                 (kd, "directions_packed", kd.directions_packed_plain),
                 (kf, "flow_solve_area", kf.flow_solve_area_plain),
                 (kf, "vis_solve", kf.vis_solve_plain),
                 (kl, "relax_sweep", kl.relax_sweep_twin),
                 (kl, "relax_solve", kl.relax_solve_twin)]
        with contextlib.ExitStack() as stack:
            for mod, name, fn in swaps:
                stack.enter_context(mock.patch.object(mod, name, fn))
            yield

    kernels = []
    N = W * H
    plane = 4.0 * N

    def solve_note(st):
        """A tiled K7/K8 solve's LAST_SOLVE entry, in words."""
        return (f"{st['rounds']} rounds to the certifying one, "
                f"{st['launched']} launched, {st['host_reads']} host reads, "
                f"{st['tiles_run']} tile visits, at most "
                f"{st['max_inner_sweeps']} inner sweeps a visit")

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
        assert torch.equal(got, want), (iters, err, scale)
        print(f"  pressure {iters} sweeps: max|p| {scale:.4g}, bit for bit "
              f"in {kj.launches(iters)} launches")
        worst = max(worst, err)
    k = kj.SWEEPS_PER_LAUNCH
    # K11e, the packed form of the same solves (phase 9), as the yardstick
    ob_3 = kp.pack_ob(terrain, grid, sea_bit=True)
    tab_3 = kp.row_table(grid, "pressure", dev)
    k11e_ms = cuda_ms(lambda: kp.resident_call_packed(
        ob_3, tab_3, coeffs[5], [p0], grid, 200, True, False), 10)
    ms = cuda_ms(lambda: kj.pressure_solve_cuda(*coeffs, p0, grid, 200), 10)
    plain_ms = cuda_ms(
        lambda: kj.pressure_solve_plain(*coeffs, p0, grid, 200), 3)
    record("jacobi_pressure", "demiurge_tpu_torch/csrc/jacobi.cu",
           "demiurge_tpu/pallas_kernels/jacobi.py:407", worst, ms, plain_ms,
           8 * plane, 200 * 9 * N,
           f"200+1000 sweeps bit for bit; time per 200-sweep solve, "
           f"{kj.launches(200)} launches of k={k} sweeps on "
           f"{kj.PRESSURE_TILE[0]}x{kj.PRESSURE_TILE[1]} tiles; K11e "
           f"{k11e_ms:.3f} ms")

    dco = kj.diffusion_coefficients(terrain, grid)
    gu, gv = kj.diffusion_solve_cuda(*dco, u, v, grid, 50)
    wu, wv = kj.diffusion_solve_plain(*dco, u, v, grid, 50)
    torch.cuda.synchronize()
    scale = float(wu.abs().max())
    err = max(max_err(gu, wu), max_err(gv, wv))
    assert scale > 0 and torch.equal(gu, wu) and torch.equal(gv, wv), \
        (err, scale)
    ob_3 = kp.pack_ob(terrain, grid, sea_bit=False)
    tab_3 = kp.row_table(grid, "viscosity", dev)
    k11e_ms = cuda_ms(lambda: kp.resident_call_packed(
        ob_3, tab_3, None, [u, v], grid, 50, False, True), 10)
    ms = cuda_ms(lambda: kj.diffusion_solve_cuda(*dco, u, v, grid, 50), 10)
    plain_ms = cuda_ms(lambda: kj.diffusion_solve_plain(*dco, u, v, grid, 50),
                       3)
    record("jacobi_diffusion", "demiurge_tpu_torch/csrc/jacobi.cu",
           "demiurge_tpu/pallas_kernels/jacobi.py:429", err, ms, plain_ms,
           9 * plane, 50 * 2 * 9 * N,
           f"50 sweeps on (u, v) bit for bit, {kj.launches(50)} launches "
           f"of k={k} on {kj.DIFFUSION_TILE[0]}x{kj.DIFFUSION_TILE[1]} "
           f"tiles; K11e {k11e_ms:.3f} ms")
    del ob_3, tab_3

    def sampler_inputs(u_, v_, g_):
        """K4's (dx, dy), strip table and Ry on g_ for (u_, v_): the
        ocean's departure points, clamped as ``ocean.advect`` clamps
        them."""
        s2, t2 = ocean._departure(u_, v_, g_, cfg)[:2]
        c, r = ocean._row_col(g_, dev)
        radii = ka.strip_radii(g_, ocean.resolved_vmax(cfg), cfg.timestep)
        ry = ocean.tap_radius_y(g_, cfg)
        rxrow = ocean._strip_radius_rows(radii, ka.STRIP, dev)
        dx = torch.clamp(s2 * g_.width - 0.5 - c, -rxrow, rxrow)
        dy = torch.clamp(t2 * g_.height - 0.5 - r, -ry, ry)
        return dx, dy, ka.strip_meta(radii, g_.width), ry

    # both solves and the sampler once at the coupled CLI's default size
    big_grid = Grid(*BIG)
    t_big = cli._terrain(big_grid, SEED, dev)
    u_big, v_big = ocean.init_ocean(big_grid, dev)
    with plain_twins():
        u_big, v_big, _, _ = ocean.ocean_step(u_big, v_big, t_big, big_grid,
                                              cfg)
    c_big = kj.coefficients(ocean.divergence(u_big, v_big, t_big, big_grid,
                                             cfg), t_big, big_grid)
    p_big = torch.zeros_like(u_big)
    got = kj.pressure_solve_cuda(*c_big, p_big, big_grid, 200)
    want = kj.pressure_solve_plain(*c_big, p_big, big_grid, 200)
    torch.cuda.synchronize()
    assert bool(want.abs().max() > 0) and torch.equal(got, want), \
        max_err(got, want)
    del c_big, got, want
    d_big = kj.diffusion_coefficients(t_big, big_grid)
    gu, gv = kj.diffusion_solve_cuda(*d_big, u_big, v_big, big_grid, 50)
    wu, wv = kj.diffusion_solve_plain(*d_big, u_big, v_big, big_grid, 50)
    torch.cuda.synchronize()
    assert torch.equal(gu, wu) and torch.equal(gv, wv), \
        max(max_err(gu, wu), max_err(gv, wv))
    def stage_against_twin(label, u_, v_, t_, g_):
        """The fused advect stage against its twin with the plain tap sum
        in place of the sampler kernel (so the two share no kernel code):
        within 1e-6 of max|u|, NaN and inf where the twin's are, one
        launch.  Returns (max error, the differing values in words)."""
        with mock.patch.object(ka, "advect_sample",
                               ka.advect_sample_tiered_plain):
            wu, wv = ka.advect_stage_plain(u_, v_, t_, g_, cfg)
        scale = float(torch.maximum(wu.abs().max(), wv.abs().max()))
        n0 = ka.LAUNCHES_STAGE
        gu, gv = ka.advect_stage_cuda(u_, v_, t_, g_, cfg)
        assert ka.LAUNCHES_STAGE - n0 == 1
        torch.cuda.synchronize()
        for a, b in ((gu, wu), (gv, wv)):
            assert torch.equal(torch.isnan(a), torch.isnan(b)), label
            assert torch.equal(torch.isinf(a), torch.isinf(b)), label
        err = max(max_err(torch.nan_to_num(gu), torch.nan_to_num(wu)),
                  max_err(torch.nan_to_num(gv), torch.nan_to_num(wv)))
        differ = int(((gu != wu) & ~torch.isnan(wu)).sum()
                     + ((gv != wv) & ~torch.isnan(wv)).sum())
        assert scale > 0 and err <= 1e-6 * scale, (label, err)
        note = (f"{differ} of {2 * u_.numel()} values differ, max err "
                f"{err:.3e}")
        print(f"  fused advect stage at {label} against its twin with the "
              f"plain tap sum (max|u|, |v| {scale:.4g}): {note}")
        return err, note

    stage_checks = {f"{BIG[0]}x{BIG[1]}": stage_against_twin(
        f"{BIG[0]}x{BIG[1]}", u_big, v_big, t_big, big_grid)}
    dx, dy, meta, ry = sampler_inputs(u_big, v_big, big_grid)
    gu, gv = ka.advect_sample_cuda(u_big, v_big, dx, dy, meta, ka.STRIP, ry)
    wu, wv = ka.advect_sample_tiered_plain(u_big, v_big, dx, dy, meta,
                                           ka.STRIP, ry)
    torch.cuda.synchronize()
    err_big = max(max_err(gu, wu), max_err(gv, wv))
    assert err_big <= 1e-5, err_big
    print(f"  at {BIG[0]}x{BIG[1]}: pressure 200 sweeps and viscosity 50 "
          f"sweeps on (u, v) bit for bit against their twins; the advect "
          f"sampler (K4, strips (rx, q) "
          f"{sorted(set(map(tuple, meta.tolist())))}, Ry {ry}) max err "
          f"{err_big:.3e} (atol 1e-5)")
    del t_big, u_big, v_big, p_big, d_big, gu, gv, wu, wv, dx, dy
    torch.cuda.empty_cache()

    dx, dy, meta, ry = sampler_inputs(u, v, grid)
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
           6 * plane, 40 * N,
           "the sampler form on real clamped (dx, dy), atol 1e-5; no main "
           "path launches it (the stage form runs the advect there)")

    # K4b: the single-radius form (one-row table), which the ocean takes on
    # the card when H is not a whole number of 32-row strips
    grid_b = Grid(W, HB)
    ub, vb = u[:HB].contiguous(), v[:HB].contiguous()
    s2b, t2b = ocean._departure(ub, vb, grid_b, cfg)[:2]
    cb, rb = ocean._row_col(grid_b, dev)
    rx1, ry1 = cfg.tap_radius_x, cfg.tap_radius_y
    dxb = torch.clamp(s2b * W - 0.5 - cb, -rx1, rx1)
    dyb = torch.clamp(t2b * HB - 0.5 - rb, -ry1, ry1)
    one_row = ka.global_meta(rx1)
    gu, gv = ka.advect_sample_cuda(ub, vb, dxb, dyb, one_row, HB, ry1)
    wu, wv = ka.advect_sample_tiered_plain(ub, vb, dxb, dyb, one_row, HB,
                                           ry1)
    torch.cuda.synchronize()
    err = max(max_err(gu, wu), max_err(gv, wv))
    assert err <= 1e-5, err
    ms = cuda_ms(lambda: ka.advect_sample_cuda(ub, vb, dxb, dyb, one_row,
                                               HB, ry1), 20)
    plain_ms = cuda_ms(lambda: ka.advect_sample_tiered_plain(
        ub, vb, dxb, dyb, one_row, HB, ry1), 3)
    nb_ = W * HB
    record("advect_sample_pallas", "demiurge_tpu_torch/csrc/advect.cu",
           "demiurge_tpu/pallas_kernels/advect.py:297", err, ms, plain_ms,
           6 * 4.0 * nb_, 40 * nb_,
           f"K4b's sampler form at {W}x{HB}: one-row table (Rx {rx1}, Ry "
           f"{ry1}), atol 1e-5; no main path launches it (the stage form "
           f"with this table does: advect_stage_one_row)")

    # the fused stage: at 2048x1000 (the one-row table) and 2048x1024
    terrain_b = terrain[:HB].contiguous()
    stage_checks[f"{W}x{HB}"] = stage_against_twin(f"{W}x{HB}", ub, vb,
                                                   terrain_b, grid_b)
    stage_b_ms = device_ms(lambda: ka.advect_stage_cuda(
        ub, vb, terrain_b, grid_b, cfg), 20)
    stage_b_plain_ms = cuda_ms(lambda: ka.advect_stage_plain(
        ub, vb, terrain_b, grid_b, cfg), 5)
    stage_checks[f"{W}x{H}"] = stage_against_twin(f"{W}x{H}", u, v, terrain,
                                                  grid)
    ms = device_ms(lambda: ka.advect_stage_cuda(u, v, terrain, grid, cfg),
                   20)
    call_ms = cuda_ms(lambda: ka.advect_stage_cuda(u, v, terrain, grid,
                                                   cfg), 20)
    sampler_ms = device_ms(lambda: ka.advect_sample_cuda(
        u, v, dx, dy, meta, ka.STRIP, ry), 20)
    plain_ms = cuda_ms(lambda: ka.advect_stage_plain(u, v, terrain, grid,
                                                     cfg), 5)
    print(f"  fused advect stage at {W}x{H}: {ms:.4f} device ms "
          f"(launches queued ahead of the host), a call on the host's "
          f"clock {call_ms:.4f} ms; the sampler form alone {sampler_ms:.4f} "
          f"ms; twin {plain_ms:.3f} ms; at {W}x{HB} (one-row table) "
          f"{stage_b_ms:.4f} ms, twin {stage_b_plain_ms:.3f} ms ({card})")
    # per pixel: ~300 float operations (backtrace, taps, transport back,
    # forcing) and 7 libm calls
    tiered_checks = [stage_checks[k] for k in (f"{W}x{H}",
                                               f"{BIG[0]}x{BIG[1]}")]
    record("advect_stage", "demiurge_tpu_torch/csrc/advect.cu",
           "demiurge_tpu/pallas_kernels/advect.py:235",
           max(e for e, _ in tiered_checks), ms, plain_ms, 5 * plane,
           300 * N,
           f"the whole single-card advect stage in one launch, tiered "
           f"table (device time, launches queued ahead; a call on the "
           f"host's clock {call_ms:.4f} ms; the sampler form "
           f"{sampler_ms:.4f}); against the twin (torch ops around the "
           f"plain tap sum): {W}x{H}: {tiered_checks[0][1]} | "
           f"{BIG[0]}x{BIG[1]}: {tiered_checks[1][1]}")
    err_b, note_b = stage_checks[f"{W}x{HB}"]
    record("advect_stage_one_row", "demiurge_tpu_torch/csrc/advect.cu",
           "demiurge_tpu/pallas_kernels/advect.py:297", err_b, stage_b_ms,
           stage_b_plain_ms, 5 * 4.0 * nb_, 300 * nb_,
           f"the stage form with the one-row table at {W}x{HB} (device "
           f"time, launches queued ahead); against the twin (torch ops "
           f"around the plain tap sum): {note_b}")
    del terrain_b

    # the projection stage (K13) against its twin at the two CLI sizes
    tile = f"{kpr.TILE[0]}x{kpr.TILE[1]}"
    races = {}
    for size in (BIG, (W, H)):
        races[size] = project_race.race(*size, [kpr.TILE], 50, SEED)
        print(f"  projection: {json.dumps(races[size])} ({card})")
    big_race, race = races[BIG], races[(W, H)]
    record("ocean_project", "demiurge_tpu_torch/csrc/project.cu",
           "none: XLA's fused project, demiurge_tpu/ops/ocean.py:596", 0.0,
           big_race["tiles"][tile]["ms"], big_race["twin_ms"],
           24.0 * BIG[0] * BIG[1], 100 * BIG[0] * BIG[1],
           f"the whole single-card projection in one launch at "
           f"{BIG[0]}x{BIG[1]}, bit for bit there and at {W}x{H} (device "
           f"time, launches queued ahead); {W}x{H}: "
           f"{race['tiles'][tile]['ms']} ms, twin {race['twin_ms']} ms, "
           f"bound {race['bound_ms']} ms; what the inputs need (12 bytes "
           f"a land pixel): {big_race['need_ms']} and {race['need_ms']} ms")
    del races

    # -- 4. the ocean path, counted ------------------------------------------
    zero_counts()
    log_text = io.StringIO()
    with contextlib.redirect_stderr(log_text):
        cli.main(["ocean", "--steps", "1"])
        cli.main(["ocean", "--steps", "5", "--jacobi", "200"])
        cli.main(["ocean", "--width", str(W), "--height", str(HB), "--steps",
                  "1", "--jacobi", "200"])
    torch.cuda.synchronize()
    u, v = u0, v0
    t0 = time.perf_counter()
    for _ in range(5):
        u, v, p, d = ocean.ocean_step(u, v, terrain, grid, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    ocean_launches = read_counts(["jacobi_pressure", "jacobi_diffusion",
                                  "advect_sample_tiered",
                                  "advect_sample_pallas", "advect_stage",
                                  "advect_stage_one_row", "ocean_project"])
    ocean_forms = own_forms(read_counts(list(counters)))
    records = [json.loads(line) for line in log_text.getvalue().splitlines()
               if line.startswith("{")]
    for rec in records:
        print("cli:", json.dumps(rec))
    assert len(records) == 7, log_text.getvalue()
    assert all("advect_clamped" in rec for rec in records)
    for name, n in ocean_launches.items():
        assert n > 0, f"{name} was never launched on the ocean path"
    # 12 steps (7 CLI, 5 ocean_step), one fused advect launch each, one of
    # them on the one-row table; the sampler form never ran
    assert ocean_launches["advect_stage"] == 12, ocean_launches
    assert ocean_launches["advect_sample_tiered"] == 12, ocean_launches
    assert ocean_launches["advect_sample_pallas"] == 1, ocean_launches
    assert ocean_launches["advect_stage_one_row"] == 1, ocean_launches
    assert ocean_launches["ocean_project"] == 12, ocean_launches
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
    print(f"launches on the ocean path: {ocean_launches}; each advect "
          f"form's own: " + json.dumps({n: ocean_forms[n] for n in (
              "advect_sample_tiered", "advect_sample_pallas",
              "advect_stage", "advect_stage_one_row")}))

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

    def same(a, b) -> bool:
        """Bit for bit, NaN where b has NaN."""
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))

    def band_note(plan, g_) -> str:
        """A band kernel's launches in words: bands of th rows with their
        halo, clusters of blocks of seg columns."""
        return "; ".join(
            f"{b.nbands(g_.height)} bands of {b.th} rows + {b.halo} halo, "
            f"clusters of {b.cluster} x {b.seg} columns" for b in plan)

    # K1 and K5 bit for bit against their twins: at 2048x1024 (timed), at
    # the coupled CLI's 8192x4096, and K1 over a climate dispatch (250
    # substeps) at the climate CLI's 4096x2048, where the reference's
    # substep diverges on land: NaNs and infs where the twin's are
    T = state.temperature
    asr = temperature.insolation_table(grid, state.t_index, 10, 0.30)
    cinv = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
            / temperature.heat_capacity(h)).contiguous()
    rlist = ob.sigma_list(ccfg.flow_preblur)

    def band_inputs(g_, substeps):
        """The same recipe on a larger grid: the terrain, T = 50 C plus a
        tenth of the height, its cinv and the insolation of ``substeps``
        substeps."""
        h_ = cli._terrain(g_, SEED, dev)
        t_ = temperature.init_temperature(g_, dev) + 0.1 * h_
        a_ = temperature.insolation_table(
            g_, torch.full((), 3.0, device=dev), substeps, 0.30)
        c_ = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
              / temperature.heat_capacity(h_)).contiguous()
        return h_, t_, c_, a_

    band_ms = {}
    for label, g_, inputs in (
            (f"{W}x{H}", grid, (h, T, cinv, asr)),
            (f"{BIG[0]}x{BIG[1]}", Grid(*BIG), None),
            (f"{CLIMATE[0]}x{CLIMATE[1]}, 250 substeps", Grid(*CLIMATE),
             None)):
        h_, t_, c_, a_ = inputs or band_inputs(
            g_, 250 if "250" in label else 10)
        n0 = kc.LAUNCHES
        got = kc.climate_step_cuda(t_, c_, a_, g_, 0.55e6)
        k1_launches = kc.LAUNCHES - n0
        want = kc.climate_step_plain(t_, c_, a_, g_, 0.55e6)
        torch.cuda.synchronize()
        assert same(got, want) and torch.equal(torch.isinf(got),
                                               torch.isinf(want)), label
        finite = float(torch.isfinite(want).float().mean())
        k1_plan = [b for _, _, b in kc.card_launches(g_, a_.shape[0])]
        assert k1_launches == len(k1_plan)
        assert k1_launches <= (32 if "250" in label else 2), k1_launches
        k1_ms = cuda_ms(lambda: kc.climate_step_cuda(t_, c_, a_, g_, 0.55e6),
                        20 if g_ is grid else 3)
        line = (f"  K1 {label}: bit for bit (finite share {finite:.4f}), "
                f"{k1_launches} launches ({band_note(k1_plan, g_)}), "
                f"{k1_ms:.3f} ms")
        if "250" not in label:
            n0 = kb.LAUNCHES
            got = kb.blur_cuda(h_, g_, rlist)
            k5_launches = kb.LAUNCHES - n0
            want = kb.blur_plain(h_, g_, rlist)
            torch.cuda.synchronize()
            assert torch.equal(got, want), label
            k5_plan = [b for _, _, _, b in kb.card_launches(g_, rlist)]
            assert k5_launches == len(k5_plan) == 1, k5_launches
            k5_ms = cuda_ms(lambda: kb.blur_cuda(h_, g_, rlist),
                            20 if g_ is grid else 3)
            line += (f"; K5 radius {ccfg.flow_preblur}: bit for bit, "
                     f"{k5_launches} launch ({band_note(k5_plan, g_)}), "
                     f"{k5_ms:.3f} ms")
            band_ms[label] = (k1_ms, k5_ms)
        print(line + f" ({card})")
        del got, want, t_, c_, a_, h_
    torch.cuda.empty_cache()

    ms = band_ms[f"{W}x{H}"][0]
    plain_ms = cuda_ms(
        lambda: kc.climate_step_plain(T, cinv, asr, grid, 0.55e6), 3)
    record("climate", "demiurge_tpu_torch/csrc/climate.cu",
           "demiurge_tpu/pallas_kernels/climate.py:132", 0.0, ms, plain_ms,
           3 * plane, 10 * 14 * N,
           f"10 substeps bit for bit at {W}x{H} and {BIG[0]}x{BIG[1]}, 250 "
           f"at {CLIMATE[0]}x{CLIMATE[1]} (NaNs included)")

    ms = band_ms[f"{W}x{H}"][1]
    plain_ms = cuda_ms(lambda: kb.blur_plain(h, grid, rlist), 3)
    want = kb.blur_plain(h, grid, rlist)
    record("blur", "demiurge_tpu_torch/csrc/blur.cu",
           "demiurge_tpu/pallas_kernels/blur.py:135", 0.0, ms, plain_ms,
           2 * plane, len(rlist) * 62 * N,
           f"radius {ccfg.flow_preblur}: {len(rlist)} iterations bit for "
           f"bit at {W}x{H} and {BIG[0]}x{BIG[1]}")

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
           f"{ties} ties of {N} pixels (bound 1 per 10^4); the codes-only "
           f"form, which the mesh step runs")

    def packed_against_twin(label, hb_, sel_, g_):
        """K6's packed form in one launch: its codes against the plain
        twin (ties at most 1 per 10^4 pixels) and its packed masks exactly
        pack_masks of its own codes and their mouths.  Returns the ties
        and the max error of the codes and of the packed field."""
        n0 = kd.LAUNCHES_PACKED
        code_k, packed_k = kd.directions_packed_cuda(hb_, sel_, g_)
        assert kd.LAUNCHES_PACKED - n0 == 1
        want_code = kd.flow_directions_plain(hb_, sel_, g_)
        _, mouth_k, _ = of.incoming_mask(code_k, g_)
        want_packed = kf.pack_masks(code_k, mouth_k, g_)
        torch.cuda.synchronize()
        ties_ = int((code_k != want_code).sum())
        err_ = max(max_err(code_k, want_code),
                   max_err(packed_k, want_packed))
        assert ties_ <= hb_.numel() // 10000, (label, ties_)
        assert torch.equal(packed_k, want_packed), label
        print(f"  packed directions at {label}: {ties_} ties of "
              f"{hb_.numel()} pixels; packed masks equal pack_masks of its "
              f"codes ({int(((packed_k >> 16) & 1).sum())} mouths)")
        return ties_, err_

    packed_checks = {f"{W}x{H}": packed_against_twin(f"{W}x{H}", hb, sel,
                                                     grid)}

    def parent_masks(hb_, sel_, g_):
        """The codes and masks as the tree before the packed form made
        them: the codes kernel, then incoming_mask and pack_masks."""
        code_ = kd.flow_directions(hb_, sel_, g_)
        _, mouth_, _ = of.incoming_mask(code_, g_)
        return code_, kf.pack_masks(code_, mouth_, g_)

    packed_ms = device_ms(lambda: kd.directions_packed_cuda(hb, sel, grid),
                          20)
    packed_call_ms = cuda_ms(lambda: kd.directions_packed_cuda(hb, sel, grid),
                             20)
    codes_ms = device_ms(lambda: kd.flow_directions_cuda(hb, sel, grid), 20)
    parent_ms = cuda_ms(lambda: parent_masks(hb, sel, grid), 5)
    packed_plain_ms = cuda_ms(
        lambda: kd.directions_packed_plain(hb, sel, grid), 3)
    print(f"  packed directions at {W}x{H}: {packed_ms:.4f} device ms "
          f"(launches queued ahead of the host), a call on the host's "
          f"clock {packed_call_ms:.4f} ms; the codes-only form "
          f"{codes_ms:.4f} device ms; the parent's codes kernel + "
          f"incoming_mask + pack_masks {parent_ms:.3f} ms ({card})")

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
        print(f"  flow A {label}: bit-exact; {solve_note(stats)}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms ({card})")
    k_ms, p_ms, stats = solves["warm"]
    record("flow_solve", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/flow.py:294", 0.0, k_ms, p_ms,
           4 * plane, edges + N,
           f"A bit-exact cold and warm; time of the warm solve (a step "
           f"after the first): {solve_note(stats)}")

    got = kf.vis_solve_cuda(packed, grid)
    stats = dict(kf.LAST_SOLVE["vis"])
    want = kf.vis_solve_plain(packed, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ms = cuda_ms(lambda: kf.vis_solve_cuda(packed, grid), 3)
    plain_ms = cuda_ms(lambda: kf.vis_solve_plain(packed, grid), 1)
    print(f"  vis: exact; {solve_note(stats)}; reachable "
          f"{float(got.float().mean()):.3f}")
    record("flow_vis", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/visbits.py:102", 0.0, ms, plain_ms,
           plane + N, edges,
           f"vis exact (K8; also serves K9): {solve_note(stats)}")

    # K7 and K8 on a hand-built serpentine river, and on a grid that the
    # tiles do not divide, against their twins
    g_r = Grid(*RAGGED)
    hb_r = ob.blur(cli._terrain(g_r, SEED, dev), g_r, ccfg.flow_preblur)
    packed_checks[f"{RAGGED[0]}x{RAGGED[1]}"] = packed_against_twin(
        f"{RAGGED[0]}x{RAGGED[1]}", hb_r, torch.ones_like(hb_r), g_r)
    g_b = Grid(*BIG)
    hb_b = ob.blur(cli._terrain(g_b, SEED, dev), g_b, ccfg.flow_preblur)
    packed_checks[f"{BIG[0]}x{BIG[1]}"] = packed_against_twin(
        f"{BIG[0]}x{BIG[1]}", hb_b, torch.ones_like(hb_b), g_b)
    del hb_b
    torch.cuda.empty_cache()
    record("flow_directions_packed", "demiurge_tpu_torch/csrc/directions.cu",
           "demiurge_tpu/pallas_kernels/directions.py:152",
           max(e for _, e in packed_checks.values()), packed_ms,
           packed_plain_ms, 5 * plane, 103 * N,
           f"codes and packed masks in one launch (device time, launches "
           f"queued ahead; a call on the host's clock {packed_call_ms:.4f} "
           f"ms; the codes-only form {codes_ms:.4f}); ties against the "
           f"plain codes "
           f"{json.dumps({k: t for k, (t, _) in packed_checks.items()})}, "
           f"packed masks exact; "
           f"the parent's codes kernel + incoming_mask + pack_masks "
           f"{parent_ms:.3f} ms")
    code_r = of.flow_directions(hb_r, torch.ones_like(hb_r), g_r)
    _, mouth_r, _ = of.incoming_mask(code_r, g_r)
    for label, g_, (pk_, ar_) in (
            ("serpentine", grid, serpentine(grid, dev, W - 16, 32, 200)),
            (f"{RAGGED[0]}x{RAGGED[1]}", g_r,
             (kf.pack_masks(code_r, mouth_r, g_r),
              of.cell_area_lower_edge(g_r, dev)))):
        got_A = kf.flow_solve_area_cuda(pk_, ar_, g_)
        st_A = dict(kf.LAST_SOLVE["A"])
        got_v = kf.vis_solve_cuda(pk_, g_)
        st_v = dict(kf.LAST_SOLVE["vis"])
        want_A = kf.flow_solve_area_plain(pk_, ar_, g_)
        want_v = kf.vis_solve_plain(pk_, g_)
        torch.cuda.synchronize()
        assert torch.equal(got_A, want_A), label
        assert torch.equal(got_v, want_v), label
        print(f"  flow A and vis on the {label}: bit-exact; A "
              f"{solve_note(st_A)}; vis {solve_note(st_v)}")
    del hb_r, code_r, mouth_r, pk_, ar_, got_A, got_v, want_A, want_v

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
    band_counts = {}   # K1 and K5 launches of each run, read after it

    def band_run(label, argv):
        before = read_counts(["climate", "blur"])
        out = cli.main(argv)
        band_counts[label] = {k: v - before[k] for k, v in
                              read_counts(["climate", "blur"]).items()}
        return out

    with contextlib.redirect_stderr(log_text):
        band_run(f"coupled {W}x{H}, 3 steps",
                 ["coupled", "--width", str(W), "--height", str(H),
                  "--steps", "3"])
        big = band_run(f"coupled {BIG[0]}x{BIG[1]}, 1 step",
                       ["coupled", "--steps", "1"])
        clim = band_run(f"climate {CLIMATE[0]}x{CLIMATE[1]}, 500 substeps "
                        f"(2 dispatches)", ["climate", "--steps", "500"])
    torch.cuda.synchronize()
    totals = read_counts(list(counters))
    launches = {n: totals[n] for n in single_card}
    coupled_forms = own_forms(totals)
    print(f"K1 and K5 launches by run: {json.dumps(band_counts)}")
    per_step = band_counts[f"coupled {W}x{H}, 3 steps"]
    assert per_step["climate"] <= 2 * 3 and per_step["blur"] <= 2 * 3
    assert band_counts[f"climate {CLIMATE[0]}x{CLIMATE[1]}, 500 substeps "
                       f"(2 dispatches)"]["climate"] <= 32 * 2
    records = [json.loads(line) for line in log_text.getvalue().splitlines()
               if line.startswith("{")]
    for rec in records:
        print("cli:", json.dumps(rec))
    print(f"launches on the coupled path: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the coupled path"
    # 4 coupled steps: one fused advect and one packed directions launch
    # each, and neither stage's other form (the totals count both forms)
    for fused, every in (("advect_stage", "advect_sample_tiered"),
                         ("flow_directions_packed", "flow_directions")):
        assert totals[fused] == totals[every] == 4, totals
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
        # temperature.temperature_step, its three parts apart
        i0 = temperature._as_index(st.t_index, dev)
        asr_s = temperature.insolation_table(grid, i0, ccfg.climate_substeps,
                                             0.30)
        mark("climate insolation table")
        cinv_s = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
                  / temperature.heat_capacity(st.height)).contiguous()
        mark("climate heat-capacity build")
        T = kc.climate_step(st.temperature.contiguous(), cinv_s, asr_s, grid,
                            0.55e6)
        ti = i0 + float(ccfg.climate_substeps)
        mark(f"climate ({ccfg.climate_substeps} substeps, K1)")
        oc = ccfg.ocean
        uu, vv = ocean.advect(st.u, st.v, st.height, grid, oc)
        mark("ocean advect (K4, fused)")
        # ocean.diffusion and ocean.pressure_solve, their coefficient
        # builds apart from the sweeps
        dco = kj.diffusion_coefficients(st.height, grid)
        mark("ocean viscosity coefficients")
        uu, vv = kj.diffusion_solve(*dco, uu, vv, grid, oc.diffusion_iters)
        mark(f"ocean viscosity ({oc.diffusion_iters} sweeps, K3)")
        dv = ocean.divergence(uu, vv, st.height, grid, oc)
        mark("ocean divergence")
        pco = kj.coefficients(dv, st.height, grid)
        mark("ocean pressure coefficients")
        pp = kj.pressure_solve(*pco, torch.zeros_like(dv), grid,
                               oc.jacobi_iters)
        mark(f"ocean pressure ({oc.jacobi_iters} sweeps, K2)")
        uu, vv = ocean.project(uu, vv, pp, st.height, grid, oc)
        mark("ocean projection")
        hbs = ob.blur(st.height, grid, ccfg.flow_preblur)
        mark("flow pre-blur")
        _, pk = kd.directions_packed(hbs.contiguous(), st.sel.contiguous(),
                                     grid)
        ar = of.cell_area_lower_edge(grid, dev)
        mark("flow directions + masks (K6, fused)")
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

    from demiurge_tpu_torch.kernels import launch_counts

    prev = model.coupled_step(start, grid, ccfg)  # a warm flow_acc
    want = model.coupled_step(prev, grid, ccfg)
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev, launch_counts()))

    def device_kernels():
        """Device kernels, and copies and fills, of one coupled_step
        (torch.profiler)."""
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model.coupled_step(prev, grid, ccfg)
            torch.cuda.synchronize()
        kinds = {"kernels": 0, "copies and fills": 0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kinds["copies and fills" if e.name.startswith(
                    ("Memcpy", "Memset")) else "kernels"] += 1
        return kinds

    # one staged step, timed between stages, equal to coupled_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark("start")
    got = staged_step(prev, mark)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    for name in ("height", "u", "v", "temperature", "flow_acc"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    rows = []
    for (_, ev0, n0), (name, ev, n1) in zip(events, events[1:]):
        n0, n1 = own_forms(n0), own_forms(n1)
        fired = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
        rows.append((name, ev0.elapsed_time(ev), fired))
    total = events[0][1].elapsed_time(events[-1][1])
    print(f"profile of one warm coupled step at {W}x{H} (CUDA events on "
          f"the stream; device-timeline ms, gaps included; each kernel "
          f"form's launches in the row; {card}):")
    for name, t, fired in rows:
        print(f"  {name:40s} {t:9.3f} ms  {100 * t / total:5.1f}%  "
              f"{json.dumps(fired)}")
    print(f"  {'sum of rows':40s} {sum(t for _, t, _ in rows):9.3f} ms; "
          f"first-to-last event {total:.3f} ms; host clock "
          f"{host_ms:.3f} ms")
    print(f"device kernels in one coupled step (torch.profiler): "
          f"{json.dumps(device_kernels())}")

    # -- 8. the sharded path on a 1x1 mesh (NCCL, world size 1) -----------
    import torch.distributed as tdist

    from demiurge_tpu_torch.dist import halo as dhalo
    from demiurge_tpu_torch.dist import local as dlocal
    from demiurge_tpu_torch.dist import mesh as dmesh
    from demiurge_tpu_torch.dist.flowdist import (_pick_dist_band,
                                                  flow_solve_rows_twolevel,
                                                  flow_solve_sharded_twolevel)
    from demiurge_tpu_torch.dist.halo import flow_solve_sharded

    mdev = dmesh.initialize(DEVICE)
    mesh = dmesh.make_mesh(shape=(1, 1), device=mdev)
    print(f"mesh {mesh.ny}x{mesh.nx} on {mdev}: backend "
          f"{tdist.get_backend()}, world size {tdist.get_world_size()}")

    # K10a / K10b against their twins, each timed beside K7/K8 on the same
    # masks: the coupled path's (phase 5) at 2048x1024, band 128 as the
    # mesh picks it; a grid the 16x128 tiles do not divide, band 8 (16 bands
    # a tile row apart); the coupled CLI's 8192x4096, band 128
    def local_against_twins(label, g_, pk_, band_):
        """K10a cold (A, exit ids) and warm (the two-level re-solve from
        A_loc + the coarse graph's injections, without exit ids), and K10b
        with a zero and a boundary-row seed, each against its twin bit for
        bit; then each timed (CUDA events, 3 calls), K7 and K8 on the
        unmasked masks beside them.  Returns the times and a note."""
        Hg, Wg = g_.shape
        ar_ = of.cell_area_lower_edge(g_, dev)
        pl_ = k2.mask_local(pk_, band_)
        A_, E_ = k2.flow_local_solve_cuda(pl_, ar_, ar_, band_)
        st = {"A": dict(k2.LAST_SOLVE["A"]), "E": dict(k2.LAST_SOLVE["E"])}
        wA_, wE_ = k2.flow_local_solve_plain(pl_, ar_, ar_, band_)
        torch.cuda.synchronize()
        assert torch.equal(A_, wA_) and torch.equal(E_, wE_), label
        del wA_, wE_
        succ, m0, _, tflat_g, _, cross = k2.coarse_graph(pk_, A_, E_, band_)
        X = k2._accumulate_adaptive(succ, m0)
        inj = torch.zeros(Hg * Wg + 1, device=dev).index_add_(
            0, tflat_g, torch.where(cross, X, 0.0))[:Hg * Wg].reshape(Hg, Wg)
        ar2, a02 = ar_ + inj, A_ + inj
        del succ, m0, tflat_g, cross, X, inj
        A2, E2 = k2.flow_local_solve_cuda(pl_, ar2, a02, band_,
                                          with_exit=False)
        st["warm"] = dict(k2.LAST_SOLVE["A"])
        wA2, _ = k2.flow_local_solve_plain(pl_, ar2, a02, band_,
                                           with_exit=False)
        torch.cuda.synchronize()
        assert E2 is None and torch.equal(A2, wA2), label
        del A2, wA2
        seed_ = torch.zeros_like(ar_)
        seed_[band_ - 1::band_, ::7] = 1.0    # last rows of the bands
        seed_[band_::band_, 3::11] = 1.0      # first rows of the next bands
        reach = []
        for what, s_ in (("zero", torch.zeros_like(ar_)),
                         ("seeded", seed_)):
            got = k2.flow_local_vis_cuda(pl_, s_, band_)
            st[f"vis {what}"] = dict(k2.LAST_SOLVE["vis"])
            want = k2.flow_local_vis_plain(pl_, s_, band_)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (label, what)
            reach.append(f"{float(got.mean()):.3f}")
        ms = {"K10a cold": cuda_ms(lambda: k2.flow_local_solve_cuda(
                  pl_, ar_, ar_, band_), 3),
              "K10a warm": cuda_ms(lambda: k2.flow_local_solve_cuda(
                  pl_, ar2, a02, band_, with_exit=False), 3),
              "K10b seeded": cuda_ms(lambda: k2.flow_local_vis_cuda(
                  pl_, seed_, band_), 3),
              "K7 cold": cuda_ms(lambda: kf.flow_solve_area_cuda(
                  pk_, ar_, g_), 3),
              "K8": cuda_ms(lambda: kf.vis_solve_cuda(pk_, g_), 3)}
        print(f"  K10 at {label}, band {band_}: A and exit ids bit-exact "
              f"cold, A warm, vis exact with a zero and a seeded start "
              f"(reachable {' and '.join(reach)}); "
              f"{int((E_ >= 0).sum())} cells exit their band")
        for what, st_ in st.items():
            print(f"    {what}: {solve_note(st_)}")
        print(f"    ms ({card}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()))
        note = (f"band {band_}: " + "; ".join(
            f"{k} {solve_note(v)}" for k, v in st.items()))
        return ms, note, pl_, ar_, seed_

    band = _pick_dist_band(H // mesh.size)
    local_ms = {}
    local_ms[f"{W}x{H}"], local_note, ploc, area_l, seed = \
        local_against_twins(f"{W}x{H}", grid, packed, band)
    local_edges = float(sum(((ploc >> i) & 1).sum() for i in range(8)))
    out_edges = float((((ploc >> 8) & 0xFF) != 0).sum())
    ms = local_ms[f"{W}x{H}"]
    p_ms = cuda_ms(lambda: k2.flow_local_solve_plain(ploc, area_l, area_l,
                                                     band), 1)
    record("flow_local_solve", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/flow2.py:150", 0.0, ms["K10a cold"],
           p_ms, 5 * plane, local_edges + N,
           f"A and exit ids bit-exact; time of the cold solve (A and exit "
           f"ids), warm re-solve {ms['K10a warm']:.3f} ms, K7 cold "
           f"{ms['K7 cold']:.3f} ms; {local_note}")
    plain_ms = cuda_ms(lambda: k2.flow_local_vis_plain(ploc, seed, band), 1)
    record("flow_local_vis", "demiurge_tpu_torch/csrc/flow.cu",
           "demiurge_tpu/pallas_kernels/flow2.py:331", 0.0,
           ms["K10b seeded"], plain_ms, 3 * plane, out_edges,
           f"vis exact, zero and seeded; time of the seeded solve, K8 "
           f"{ms['K8']:.3f} ms; {local_note}")
    del ploc, area_l, seed

    g_r = Grid(*RAGGED)
    hb_r = ob.blur(cli._terrain(g_r, SEED, dev), g_r, ccfg.flow_preblur)
    code_r = of.flow_directions(hb_r, torch.ones_like(hb_r), g_r)
    _, mouth_r, _ = of.incoming_mask(code_r, g_r)
    local_ms[f"{RAGGED[0]}x{RAGGED[1]}"] = local_against_twins(
        f"{RAGGED[0]}x{RAGGED[1]}", g_r, kf.pack_masks(code_r, mouth_r, g_r),
        8)[0]
    del hb_r, code_r, mouth_r

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
        print(f"  at {g.width}x{g.height}: K7 {solve_note(k7_stats)}; "
              f"two-level: K10a "
              f"{k2.LAUNCHES_LOCAL - before} launched in its two solves, "
              f"the re-solve {solve_note(resolve)}")
        t_two = cuda_ms(lambda: k2.flow_solve_twolevel(code_, ar, mouth_, g),
                        3)
        t_k7 = cuda_ms(lambda: kf.flow_solve_area_cuda(
            kf.pack_masks(code_, mouth_, g), ar, g), 3)
        print(f"  flow_solve_twolevel at {g.width}x{g.height} (band "
              f"{k2.pick_band(g.height)}): within rtol 1e-5, atol 1e-7 of "
              f"K7; {t_two:.3f} ms against K7 {t_k7:.3f} ms (both with "
              f"pack_masks; {card})")
        return t_two, t_k7

    twolevel_ms = {f"{W}x{H}": twolevel_against_k7(grid, code, mouth)}
    big_grid = Grid(*BIG)
    hb_big = ob.blur(cli._terrain(big_grid, SEED, dev), big_grid,
                     ccfg.flow_preblur)
    code_big = of.flow_directions(hb_big, torch.ones_like(hb_big), big_grid)
    _, mouth_big, _ = of.incoming_mask(code_big, big_grid)
    del hb_big
    local_ms[f"{BIG[0]}x{BIG[1]}"] = local_against_twins(
        f"{BIG[0]}x{BIG[1]}", big_grid,
        kf.pack_masks(code_big, mouth_big, big_grid), 128)[0]
    torch.cuda.empty_cache()
    twolevel_ms[f"{BIG[0]}x{BIG[1]}"] = twolevel_against_k7(
        big_grid, code_big, mouth_big)
    del code_big, mouth_big
    torch.cuda.empty_cache()
    print(f"K10 and K7/K8 ms by grid (CUDA events, 3 calls each; {card}): "
          f"{json.dumps(local_ms)}")

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
    dmesh.reset_traffic()
    t0 = time.perf_counter()
    for _ in range(3):
        s_mesh = model.coupled_step(s_mesh, grid, ccfg, mesh=mesh)
    torch.cuda.synchronize()
    mesh_step_ms = (time.perf_counter() - t0) * 1e3 / 3
    mesh_launches = read_counts(list(counters))
    mesh_traffic = dmesh.traffic()
    print(f"launches on the mesh path (3 steps): {mesh_launches}")
    print(f"traffic of the 3 mesh steps: {json.dumps(mesh_traffic)}")
    assert mesh_traffic["sharded_call"] == 0, mesh_traffic
    assert mesh_traffic["field_gathers"] == 0, mesh_traffic
    for name in ("blur", "flow_directions", "flow_local_solve",
                 "flow_local_vis", "blur_strip", "flow_directions_strip"):
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

    def staged_mesh_step(st, mark, keep):
        """coupled_step(mesh=...) written out stage by stage; ``keep``
        collects the stages' inputs."""
        T_, ti = temperature.temperature_step(
            st.temperature, st.height, st.t_index, grid,
            ccfg.climate_substeps, mesh=mesh)
        mark("climate (row groups, 10 substeps; torch)")
        oc = ccfg.ocean
        uu, vv = ocean.advect(st.u, st.v, st.height, grid, oc, mesh=mesh)
        mark("ocean advect (block departure, sampler on blocks; torch)")
        uu, vv = ocean.diffusion(uu, vv, st.height, grid, oc, mesh=mesh)
        mark("ocean viscosity (block coefficients, halo rounds; torch)")
        keep["diffused"] = (uu, vv)
        dv = dlocal.block_call(ocean.divergence, mesh, 1, halo=(0, 1, 2),
                               negate=(0, 1))(uu, vv, st.height, grid, oc)
        mark("ocean divergence (blocks, 1-ring halo)")
        pp = ocean.pressure_solve(dv, st.height, grid, oc, mesh=mesh)
        mark("ocean pressure (block coefficients, halo rounds; torch)")
        keep["div"], keep["p"] = dv, pp
        uu, vv = dlocal.block_call(ocean.project, mesh, 1, halo=(2, 3))(
            uu, vv, pp, st.height, grid, oc)
        mark("ocean projection (blocks, 1-ring halo)")
        _, _, pk = dlocal.flow_masks_rows(st.height, st.sel, grid, mesh,
                                          ccfg.flow_preblur)
        mark("flow blur, codes, mouths, masks (row strips; K5, K6)")
        ar = of.cell_area_lower_edge(dlocal.rows_window(grid, mesh, 0), dev)
        acc, vis = flow_solve_rows_twolevel(pk, ar, grid, mesh)
        acc = dmesh.rows_to_blocks(acc, mesh, grid.height)
        vis = dmesh.rows_to_blocks(vis, mesh, grid.height) > 0.5
        mark("flow two-level solve (K10a x2, K10b x2, coarse graph)")
        fm = torch.where(vis, torch.pow(acc, ccfg.flow_exponent), -1.0)
        keep["fm"] = fm
        hh = dlocal.block_call(erosion.erosion_pass, mesh, 1, halo=(0,))(
            st.height, fm, st.uplift, grid, ccfg.erosion_factor,
            ccfg.erosion_slope_exponent)
        mark("flow map + erosion (blocks, 1-ring halo)")
        return model.CoupledState(height=hh, uplift=st.uplift, sel=st.sel,
                                  u=uu, v=vv, temperature=T_, t_index=ti,
                                  flow_acc=acc)

    want = model.coupled_step(s_mesh, grid, ccfg, mesh=mesh)
    events.clear()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    mark("start")
    keep = {}
    got = staged_mesh_step(s_mesh, mark, keep)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    step_launches = read_counts(["flow_local_solve", "flow_local_vis"])
    # the coarse graph's scatter-adds run in atomics: the two runs may
    # round the chain sums apart
    hold_to_single(got, want, "the staged mesh step against coupled_step")
    rows = [(name, events[i][1].elapsed_time(ev))
            for i, (name, ev, _) in enumerate(events[1:])]
    total = events[0][1].elapsed_time(events[-1][1])
    print(f"profile of one coupled step on the 1x1 mesh at {W}x{H} (CUDA "
          f"events; device-timeline ms, gaps included; {card}):")
    for name, t in rows:
        print(f"  {name:56s} {t:9.3f} ms  {100 * t / total:5.1f}%")
    print(f"  {'sum of rows':56s} {sum(t for _, t in rows):9.3f} ms; "
          f"first-to-last event {total:.3f} ms; host clock {host_ms:.3f} ms;"
          f" K10 launches in the step {step_launches}")
    # -- 8b. the local stages one by one on the staged step's inputs: each
    # bit for bit against the single-card stage, timed beside it and
    # beside the sharded_call form it replaced (CUDA events, 3 calls)
    oc = ccfg.ocean
    hgt, uplift8 = s_mesh.height, s_mesh.uplift
    du, dv_ = keep["diffused"]

    def sc(fn):
        return dmesh.sharded_call(fn, mesh)

    def rows_masks(h_, sel_):
        return dlocal.flow_masks_rows(h_, sel_, grid, mesh, ccfg.flow_preblur)

    def codes_and_mouths(h_, sel_, g_, preblur):
        code_ = of.flow_directions(ob.blur(h_, g_, preblur), sel_, g_)
        return code_, of.incoming_mask(code_, g_)[1]

    def single_masks(fn):
        def run(h_, sel_):
            code_, mouth_ = fn(codes_and_mouths)(h_, sel_, grid,
                                                 ccfg.flow_preblur)
            return code_, mouth_, fn(kf.pack_masks)(code_, mouth_, grid)
        return run

    ident = (lambda f: f)  # noqa: E731
    stages = [
        ("departure points", lambda f: f(ocean._departure),
         (s_mesh.u, s_mesh.v, grid, oc), dict(k=0)),
        ("divergence", lambda f: f(ocean.divergence),
         (du, dv_, hgt, grid, oc), dict(k=1, halo=(0, 1, 2), negate=(0, 1))),
        ("projection", lambda f: f(ocean.project),
         (du, dv_, keep["p"], hgt, grid, oc), dict(k=1, halo=(2, 3))),
        ("pressure coefficients", lambda f: f(kj.coefficients),
         (keep["div"], hgt, grid), dict(k=1, halo=(1,))),
        ("viscosity coefficients", lambda f: f(kj.diffusion_coefficients),
         (hgt, grid), dict(k=1, halo=(0,))),
        ("erosion pass", lambda f: f(erosion.erosion_pass),
         (hgt, keep["fm"], uplift8, grid, ccfg.erosion_factor,
          ccfg.erosion_slope_exponent), dict(k=1, halo=(0,)))]
    local_stage_ms = {}
    for name, pick, args, how in stages:
        k_ = how.pop("k")
        loc = pick(lambda fn: dlocal.block_call(fn, mesh, k_, **how))
        outs = [loc(*args), pick(ident)(*args), pick(sc)(*args)]
        outs = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
        torch.cuda.synchronize()
        for a, b in zip(outs[0], outs[1]):
            assert torch.equal(a.expand(H, W), b.expand(H, W)), name
        local_stage_ms[name] = [cuda_ms(lambda: f(*args), 3) for f in (
            loc, pick(ident), pick(sc))]
    n_strip = (kb.LAUNCHES_STRIP, kd.LAUNCHES_STRIP)
    got_m = rows_masks(hgt, s_mesh.sel)
    assert kb.LAUNCHES_STRIP > n_strip[0] and kd.LAUNCHES_STRIP > n_strip[1]
    want_m = single_masks(ident)(hgt, s_mesh.sel)
    torch.cuda.synchronize()
    mask_ties = int((got_m[0] != want_m[0]).sum())
    assert mask_ties == 0, f"{mask_ties} direction ties on the strips"
    assert torch.equal(got_m[1], want_m[1]) and torch.equal(got_m[2],
                                                            want_m[2])
    local_stage_ms["flow masks (row strips)"] = [
        cuda_ms(lambda: rows_masks(hgt, s_mesh.sel), 3),
        cuda_ms(lambda: single_masks(ident)(hgt, s_mesh.sel), 3),
        cuda_ms(lambda: single_masks(sc)(hgt, s_mesh.sel), 3)]
    print(f"local stages on the 1x1 mesh at {W}x{H}, each bit for bit "
          f"against the single-card stage on the staged step's inputs "
          f"(direction ties {mask_ties}); ms local / single card / "
          f"sharded_call (CUDA events, 3 calls; {card}):")
    for name, (a, b, c) in local_stage_ms.items():
        print(f"  {name:28s} {a:9.3f} {b:9.3f} {c:9.3f}")

    # K5 and K6's codes form on the row strips of a 4-rank mesh (on one
    # rank the strip is the whole grid): the group at the south pole
    # (ending there, the window's pole flag on) and an inner one with a
    # halo on both sides, each against its plain form on the strip and
    # the whole grid's rows; the inner one timed
    from demiurge_tpu_torch.core.grid import Window

    kr = dlocal.flow_rows_reach(ccfg.flow_preblur)
    whole_hb = kb.blur_cuda(hgt, grid, rlist)
    strip_ties = 0
    r4 = H // 4
    for group in (0, 1):
        lo, hi = max(group * r4 - kr, 0), (group + 1) * r4 + kr
        win = Window(W, hi - lo, grid.coords, grid.circumference,
                     full=(W, H), row0=lo)
        hs, ss = hgt[lo:hi].contiguous(), s_mesh.sel[lo:hi].contiguous()
        hb_k = kb.blur_cuda(hs, win, rlist)
        hb_p = kb.blur_plain(hs, win, rlist)
        cs_k = kd.flow_directions_cuda(hb_k, ss, win)
        cs_p = kd.flow_directions_plain(hb_k, ss, win)
        torch.cuda.synchronize()
        own = slice(group * r4 - lo, group * r4 - lo + r4)
        assert torch.equal(hb_k, hb_p), ("K5 on the strip", group)
        assert torch.equal(hb_k[own], whole_hb[group * r4:(group + 1) * r4])
        strip_ties += int((cs_k != cs_p).sum())
    assert strip_ties == 0, f"{strip_ties} ties of K6 on the strips"
    Ns = hs.numel()
    ms = cuda_ms(lambda: kb.blur_cuda(hs, win, rlist), 20)
    plain_ms = cuda_ms(lambda: kb.blur_plain(hs, win, rlist), 3)
    record("blur_strip", "demiurge_tpu_torch/csrc/blur.cu",
           "demiurge_tpu/pallas_kernels/blur.py:135", max_err(hb_k, hb_p),
           ms, plain_ms, 2 * 4.0 * Ns, len(rlist) * 62 * Ns,
           f"K5 on the row strips of a 4-rank mesh at {W}x{H} (the south "
           f"pole's, ending there, and an inner one, {win.height}x"
           f"{win.width}: {r4} rows and {kr} halo rows a side, timed), bit "
           f"for bit against its plain form and the whole grid's rows")
    ms = cuda_ms(lambda: kd.flow_directions_cuda(hb_k, ss, win), 20)
    plain_ms = cuda_ms(lambda: kd.flow_directions_plain(hb_k, ss, win), 3)
    record("flow_directions_strip", "demiurge_tpu_torch/csrc/directions.cu",
           "demiurge_tpu/pallas_kernels/directions.py:152",
           max_err(cs_k, cs_p), ms, plain_ms, 3 * 4.0 * Ns, 90 * Ns,
           f"K6's codes form on the same strips (its tables at the "
           f"strips' global rows), {strip_ties} ties; timed on the inner "
           f"one")
    del hs, ss, hb_k, hb_p, cs_k, cs_p, got_m, want_m, whole_hb

    # the overlapped sweeps against the monolithic ones: the pressure's 25
    # rounds of 8 and the viscosity's 5 of 10, split even though nothing
    # is in flight on one rank (the solvers split only with
    # dist.halo.OVERLAP on, and then only where something is in flight)
    pc = dlocal.block_call(kj.coefficients, mesh, 1, halo=(1,))(
        keep["div"], hgt, grid)
    dc = dlocal.block_call(kj.diffusion_coefficients, mesh, 1, halo=(0,))(
        hgt, grid)
    sweep_ms = {}
    for name, k_, coeffs, rounds, neg, start8 in (
            ("pressure", 8, pc, 25, False, torch.zeros_like(hgt)),
            ("viscosity", 10, dc + (torch.zeros_like(hgt),), 5, True, du)):
        padded = dhalo._padded_coefficients(coeffs, k_, grid, mesh) + (
            dhalo.exchange_halo(coeffs[5], k_, grid, mesh),)

        def mono(k_=k_, padded=padded, neg=neg, rounds=rounds, p=start8):
            for _ in range(rounds):
                p = dhalo._ksweeps(p, k_, padded, lambda q: (
                    dhalo.exchange_halo(q, k_, grid, mesh, negate_pole=neg)))
            return p

        def split(k_=k_, padded=padded, neg=neg, rounds=rounds, p=start8):
            for _ in range(rounds):
                p = dhalo._overlapped_ksweeps(p, k_, padded, lambda q: (
                    dhalo.post_halo(q, k_, grid, mesh, negate_pole=neg)),
                    split=True)
            return p

        dhalo.LAST_OVERLAP.update(rounds=0, split=0, in_flight=0)
        a, b = mono(), split()
        torch.cuda.synchronize()
        assert torch.equal(a, b), name
        ov = dict(dhalo.LAST_OVERLAP)
        assert ov["split"] == ov["in_flight"] == rounds, ov
        sweep_ms[name] = (cuda_ms(mono, 1), cuda_ms(split, 1))
        print(f"  {name} sweeps on the 1x1 mesh ({rounds} rounds of "
              f"{k_}): split bit for bit against monolithic, centre issued "
              f"before the wait in {ov['in_flight']} of {ov['split']} split "
              f"rounds; monolithic {sweep_ms[name][0]:.3f} ms, split "
              f"{sweep_ms[name][1]:.3f} ms ({card})")
    del pc, dc, a, b, keep
    del s_mesh, s_one, want, got
    torch.cuda.empty_cache()

    # one mesh step at BASELINE config 5's 8192x4096
    big_grid = Grid(*BIG)
    sb = model.init_coupled(cli._terrain(big_grid, SEED, dev), big_grid,
                            mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dmesh.reset_traffic()
    t0 = time.perf_counter()
    sb = model.coupled_step(sb, big_grid, ccfg, mesh=mesh)
    torch.cuda.synchronize()
    big_mesh_s = time.perf_counter() - t0
    big_traffic = dmesh.traffic()
    assert big_traffic["field_gathers"] == 0, big_traffic
    for name in ("height", "u", "v", "flow_acc"):
        assert bool(torch.isfinite(getattr(sb, name)).all()), name
    print(f"one mesh step at {BIG[0]}x{BIG[1]} on the 1x1 mesh: "
          f"{big_mesh_s * 1e3:.1f} ms (host clock, the first at this size), "
          f"max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; height, u, "
          f"v and flow_acc finite, temperature finite: "
          f"{bool(torch.isfinite(sb.temperature).all())}, mean T "
          f"{float(sb.temperature.mean()):.4g}; field gathers "
          f"{big_traffic['field_gathers']} ({card})")
    del sb
    torch.cuda.empty_cache()

    # -- 8c. the mesh cases that once ran on the gathered fields, on the 1x1
    # mesh through their entry points: none gathers a field, each held to
    # the same single-card call and timed beside it
    fallback_ms = {}
    mesh8c_forms = {n: 0 for n in counters}

    def fallback_case(label, on_mesh, on_card, bounds):
        zero_counts()
        dmesh.reset_traffic()
        got = on_mesh()
        torch.cuda.synchronize()
        tr = dmesh.traffic()
        forms = own_forms(read_counts(list(counters)))
        for n, v in forms.items():
            mesh8c_forms[n] += v
        want = on_card()
        torch.cuda.synchronize()
        print(f"  {label}: sharded_call {tr['sharded_call']}, field gathers "
              f"{tr['field_gathers']}, bytes received "
              f"{json.dumps(tr['bytes'])}; launches "
              f"{json.dumps({k: v for k, v in forms.items() if v})}")
        assert tr["sharded_call"] == 0 and tr["field_gathers"] == 0, (
            label, tr)
        for name, (rtol, atol) in bounds.items():
            a, b = got[name], want[name]
            assert a.shape == b.shape and bool(torch.isfinite(a).all()), (
                label, name)
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{label} {name}: {m}")
            print(f"    {name}: max abs err {max_err(a, b):.3e} (rtol "
                  f"{rtol}, atol {atol:.3g})")
        fallback_ms[label] = (cuda_ms(on_mesh, 1), cuda_ms(on_card, 1))
        print(f"    1x1 mesh {fallback_ms[label][0]:.3f} ms, single card "
              f"{fallback_ms[label][1]:.3f} ms (CUDA events, 1 call; "
              f"{card})")

    def state_fields(st):
        return {n: getattr(st, n) for n in mesh_bounds}

    oc = ccfg.ocean
    quirks_cfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(
        oc, exact_quirks=True))
    s0_mesh = model.init_coupled(terrain, grid, mesh=mesh)
    s0_one = model.init_coupled(terrain, grid)
    fallback_case(
        f"exact_quirks coupled step at {W}x{H}",
        lambda: state_fields(model.coupled_step(s0_mesh, grid, quirks_cfg,
                                                mesh=mesh)),
        lambda: state_fields(model.coupled_step(s0_one, grid, quirks_cfg)),
        mesh_bounds)
    s1 = model.coupled_step(s0_one, grid, ccfg)
    s2 = model.coupled_step(s1, grid, ccfg)
    p_prev = ocean.pressure_solve(ocean.divergence(
        s1.u, s1.v, s1.height, grid, oc), s1.height, grid, oc)
    div2 = ocean.divergence(s2.u, s2.v, s2.height, grid, oc)
    p_scale = float(ocean.pressure_solve(div2, s2.height, grid, oc,
                                         p0=p_prev).abs().max())
    assert p_scale > 0
    fallback_case(
        f"pressure solve at {W}x{H} warm-started from the previous step's",
        lambda: {"p": ocean.pressure_solve(div2, s2.height, grid, oc,
                                           p0=p_prev, mesh=mesh)},
        lambda: {"p": ocean.pressure_solve(div2, s2.height, grid, oc,
                                           p0=p_prev)},
        {"p": (0.0, 2e-5 * p_scale)})
    del s0_mesh, s0_one, s1, s2, p_prev, div2
    band_grid = Grid(W, H, coords=(-1.2, 1.1, -math.pi, math.pi))
    walls = torch.arange(H, device=dev).reshape(-1, 1)
    walls = (walls < 3) | (walls >= H - 3)
    hband = cli._terrain(band_grid, SEED, dev)
    hband = torch.where(walls, torch.clamp(hband, min=0.5), hband)
    sb_mesh = model.init_coupled(hband, band_grid, mesh=mesh)
    sb_one = model.init_coupled(hband, band_grid)
    fallback_case(
        f"coupled step at {W}x{H}, latitudes -1.2 to 1.1 (no pole)",
        lambda: state_fields(model.coupled_step(sb_mesh, band_grid, ccfg,
                                                mesh=mesh)),
        lambda: state_fields(model.coupled_step(sb_one, band_grid, ccfg)),
        mesh_bounds)
    del sb_mesh, sb_one, hband
    shallow = Grid(W, 128)
    T128 = temperature.init_temperature(shallow, dev)
    h128 = cli._terrain(shallow, SEED, dev)
    fallback_case(
        f"250-substep climate dispatch at {W}x128 (a 128-row strip)",
        lambda: {"temperature": temperature.temperature_step(
            T128, h128, 0.0, shallow, substeps=250, mesh=mesh)[0]},
        lambda: {"temperature": temperature.temperature_step(
            T128, h128, 0.0, shallow, substeps=250)[0]},
        {"temperature": mesh_bounds["temperature"]})
    del T128, h128
    for name in ("blur_strip", "flow_directions_strip", "flow_local_solve",
                 "flow_local_vis"):
        assert mesh8c_forms[name] > 0, f"{name} never launched in 8c"
    print(f"8c, the former gathered cases on the 1x1 mesh: ms mesh / single "
          f"card {json.dumps(fallback_ms)} ({card})")
    torch.cuda.empty_cache()
    tdist.destroy_process_group()

    # the weak-scaling tool at one rank, and its refusal of more ranks than
    # this machine has cards
    sb_cmd = [sys.executable, "-m", "demiurge_tpu_torch.tools.scaling_bench",
              "--base-width", str(W), "--base-height", str(H), "--steps", "5",
              "--ranks", "1"]
    t0 = time.perf_counter()
    run = subprocess.run(sb_cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(
                             REPO)))
    assert run.returncode == 0, (run.returncode, run.stderr[-3000:])
    (sb_rec,) = [json.loads(line) for line in run.stdout.splitlines()
                 if line.startswith("{")]
    assert sb_rec["devices"] == 1 and sb_rec["finite"], sb_rec
    print(f"scaling_bench at n = 1 ({time.perf_counter() - t0:.1f} s with "
          f"start-up): {json.dumps(sb_rec)}")
    run = subprocess.run(sb_cmd + ["--ranks", str(
        torch.cuda.device_count() + 1)], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert run.returncode == 2 and "CUDA devices" in run.stderr, run.stderr
    print(f"scaling_bench refuses {torch.cuda.device_count() + 1} ranks: "
          f"{run.stderr.strip()}")

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

    # -- 9. K11: the alternative flow solvers and the packed Jacobi --------
    t9 = time.perf_counter()
    rounds_cmd = [sys.executable, "-m", "demiurge_tpu_torch.tools.flow_rounds",
                  str(W), str(H)]
    t0 = time.perf_counter()
    run = subprocess.run(rounds_cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    for line in run.stdout.splitlines():
        print(f"flow_rounds: {line}")
    assert run.returncode == 0, (run.returncode, run.stderr[-4000:])
    rounds_line = json_lines(run.stdout)[-1]
    rounds_launches = rounds_line["kernel_launches"]
    rounds_n = int(run.stdout.split("rounds=")[1].split()[0])
    # K11d on cluster windows: one launch and one host read a round
    assert rounds_line["design"] == "cluster", rounds_line
    assert rounds_launches == {"flow_banded_rounds": rounds_n,
                               "flow_banded_sweeps": 0}, rounds_line
    assert rounds_line["host_reads"] == rounds_n > 0, rounds_line
    print(f"flow_rounds: {rounds_n} rounds, {rounds_n} launches, "
          f"{rounds_line['host_reads']} host reads (the earlier design: "
          f"k = 16 launches a round); {time.perf_counter() - t0:.1f} s "
          f"with start-up")

    # flow_tune's run in this process, each solver also held to its twin;
    # then K11e at the coupled depths, on the ocean of phase 4
    k11_names = ["flow_solve_2d_tma", "flow_solve_2d", "flow_solve_fused",
                 "flow_solve_wave_tiles", "flow_solve_wave",
                 "flow_banded_rounds", "flow_banded_sweeps", "jacobi_packed"]
    zero_counts()
    pk10, tune_rows, tune_ok = ft.run(W, H, DEVICE, twins=True)
    assert tune_ok, "flow_tune: a solver disagrees with K7/K8 or its twin"
    div_e = ocean.divergence(u, v, terrain, grid, cfg)
    co_e = kj.coefficients(div_e, terrain, grid)
    dco_e = kj.diffusion_coefficients(terrain, grid)
    ob_p = kp.pack_ob(terrain, grid, sea_bit=True)
    tab_p = kp.row_table(grid, "pressure", dev)
    ob_v = kp.pack_ob(terrain, grid, sea_bit=False)
    tab_v = kp.row_table(grid, "viscosity", dev)
    p0 = torch.zeros_like(div_e)

    def packed_pressure(fn=kp.resident_call_packed, iters=200):
        return fn(ob_p, tab_p, co_e[5], [p0], grid, iters, True, False)

    def packed_viscosity(fn=kp.resident_call_packed):
        return fn(ob_v, tab_v, None, [u, v], grid, 50, False, True)

    (got_p,) = packed_pressure()
    got_u, got_v = packed_viscosity()
    torch.cuda.synchronize()
    k11_launches = read_counts(k11_names)
    print(f"launches on the K11 paths (flow_tune, packed solves): "
          f"{k11_launches}")
    for name, n in k11_launches.items():
        assert n > 0, f"{name} was never launched on its path"
    # K11b one launch a solve: flow_tune's "both" and its split (A, then
    # vis), each checked once and timed REPS times; K11e 25 + 7 launches
    assert k11_launches["flow_solve_fused"] == 3 * (1 + ft.REPS), \
        k11_launches
    # the redesigned K11a and K11c: one launch a solve, checked once and
    # timed REPS times
    assert k11_launches["flow_solve_2d_tma"] == 1 + ft.REPS, k11_launches
    assert k11_launches["flow_solve_wave_tiles"] == 1 + ft.REPS, k11_launches
    # the redesigned K11d: one launch and one host read a round
    k11d_row = next(r for r in tune_rows
                    if r["kernel"] == "flow_banded_rounds")
    assert k11d_row["stats"]["design"] == "cluster", k11d_row
    assert k11d_row["stats"]["launches"] == k11d_row["stats"][
        "host_reads"] == k11d_row["stats"]["rounds"], k11d_row
    assert k11_launches["jacobi_packed"] == kp.launches(200) + kp.launches(
        50) == 25 + 7, k11_launches

    (want_p,) = kp.resident_call_packed_plain(ob_p, tab_p, co_e[5], [p0],
                                              grid, 200, True, False)
    want_u, want_v = kp.resident_call_packed_plain(ob_v, tab_v, None, [u, v],
                                                   grid, 50, False, True)
    k2_p = kj.pressure_solve_cuda(*co_e, p0, grid, 200)
    k3_u, k3_v = kj.diffusion_solve_cuda(*dco_e, u, v, grid, 50)
    # a count that is not a multiple of k: the remainder launch
    (got_r,) = packed_pressure(iters=61)
    (want_r,) = packed_pressure(kp.resident_call_packed_plain, 61)
    # the earlier design (one launch a sweep), the yardstick
    (old_p,) = packed_pressure(kp.resident_call_packed_sweeps_cuda)
    old_u, old_v = packed_viscosity(kp.resident_call_packed_sweeps_cuda)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_u, want_u) and torch.equal(got_v, want_v)
    assert torch.equal(got_r, want_r)
    assert torch.equal(old_p, want_p)
    assert torch.equal(old_u, want_u) and torch.equal(old_v, want_v)
    scale_p, scale_u = float(k2_p.abs().max()), float(k3_u.abs().max())
    err_p = max_err(got_p, k2_p)
    err_u = max(max_err(got_u, k3_u), max_err(got_v, k3_v))
    assert err_p <= 1e-4 * scale_p and err_u <= 2e-5 * scale_u, \
        (err_p, scale_p, err_u, scale_u)
    # in turns: the earlier design, this one, this one, the earlier one
    ms_old = [cuda_ms(lambda: packed_pressure(
        kp.resident_call_packed_sweeps_cuda), 10)]
    ms_p = [cuda_ms(packed_pressure, 10), cuda_ms(packed_pressure, 10)]
    ms_old.append(cuda_ms(lambda: packed_pressure(
        kp.resident_call_packed_sweeps_cuda), 10))
    ms_v = cuda_ms(packed_viscosity, 10)
    ms_v_old = cuda_ms(lambda: packed_viscosity(
        kp.resident_call_packed_sweeps_cuda), 10)
    ms_k2 = cuda_ms(lambda: kj.pressure_solve_cuda(*co_e, p0, grid, 200), 10)
    ms_k3 = cuda_ms(lambda: kj.diffusion_solve_cuda(*dco_e, u, v, grid, 50),
                    10)
    plain_ms = cuda_ms(lambda: kp.resident_call_packed_plain(
        ob_p, tab_p, co_e[5], [p0], grid, 200, True, False), 1)
    print(f"  packed pressure: 200 sweeps in {kp.launches(200)} launches "
          f"(was 200), 61 in {kp.launches(61)}, bit-exact against the twin; "
          f"{min(ms_p):.3f} ms ({', '.join(f'{t:.3f}' for t in ms_p)}), the "
          f"one-launch-a-sweep design {', '.join(f'{t:.3f}' for t in ms_old)}"
          f" ms, K2 {ms_k2:.3f} ms ({card})")
    print(f"  packed viscosity (50 sweeps on u, v, {kp.launches(50)} "
          f"launches): bit-exact against its twin, err/max against K3 "
          f"{err_u / scale_u:.3e}; {ms_v:.3f} ms, the earlier design "
          f"{ms_v_old:.3f} ms, K3 {ms_k3:.3f} ms ({card})")
    # a pressure sweep: cx*(pE+pW) + cy*(pN+pS) + b, 6 operations a pixel
    record("jacobi_packed", "demiurge_tpu_torch/csrc/jacobi_packed.cu",
           "attic/jacobi_packed.py:212", 0.0, min(ms_p), plain_ms,
           4 * plane, 200 * 6 * N,
           f"pressure, 200 sweeps in {kp.launches(200)} launches of k="
           f"{kp.SWEEPS_PER_LAUNCH} on {kp.TILES[1][0]}x{kp.TILES[1][1]} "
           f"tiles, two blocks an SM: bit-exact against its twin (and 61 "
           f"sweeps), err/max against K2 {err_p / scale_p:.3e}; the "
           f"earlier design {min(ms_old):.3f} ms, K2 {ms_k2:.3f} ms in the "
           f"same run; viscosity {ms_v:.3f} ms (earlier {ms_v_old:.3f}, K3 "
           f"{ms_k3:.3f})")
    record("jacobi_packed_sweeps", "demiurge_tpu_torch/csrc/jacobi_packed.cu",
           "attic/jacobi_packed.py:212", 0.0, min(ms_old), plain_ms,
           4 * plane, 200 * 6 * N,
           "K11e's earlier design, the yardstick off every path: one launch "
           "a sweep, 200 pressure sweeps")
    del want_p, want_u, want_v, k2_p, k3_u, k3_v, old_p, old_u, old_v

    def hold_k11b(label, pk, area_, g_, band):
        """K11b in every mode against its twin, K7 and K8: A bit for bit,
        vis exactly, one launch and one host read a solve; then "both"
        timed beside the earlier design and K7+K8 (CUDA events, one call
        each after the checks, in turns).  Returns (ms, bands ms, K7+K8
        ms, the stats of "both")."""
        A7 = kf.flow_solve_area_cuda(pk, area_, g_)
        vis8 = kf.vis_solve_cuda(pk, g_)
        mouth_ = ((pk >> 16) & 1).bool()
        notes = {}
        for mode in kx.MODES:
            before = kx.LAUNCHES_FUSED
            A, vis, st = kx.flow_solve_fused_cuda(pk, area_, g_, band=band,
                                                  mode=mode)
            tA, tvis, _ = kx.flow_solve_fused_plain(pk, area_, g_,
                                                    band=band, mode=mode)
            torch.cuda.synchronize()
            assert kx.LAUNCHES_FUSED - before == st["launched"] == 1
            assert st["host_reads"] == 1, st
            assert torch.equal(A, tA) and torch.equal(vis, tvis), \
                (label, mode)
            assert torch.equal(A, area_ if mode == "vis" else A7), \
                (label, mode)
            assert torch.equal(vis, mouth_ if mode == "A" else vis8), \
                (label, mode)
            notes[mode] = st
            del A, vis, tA, tvis
        A, vis, sb = kx.flow_solve_fused_bands_cuda(pk, area_, g_, band=band)
        torch.cuda.synchronize()
        assert torch.equal(A, A7) and torch.equal(vis, vis8), label
        del A, vis
        ms_k78 = cuda_ms(lambda: (kf.flow_solve_area_cuda(pk, area_, g_),
                                  kf.vis_solve_cuda(pk, g_)), 1)
        ms_new = cuda_ms(lambda: kx.flow_solve_fused_cuda(pk, area_, g_,
                                                          band=band), 1)
        ms_bands = cuda_ms(lambda: kx.flow_solve_fused_bands_cuda(
            pk, area_, g_, band=band), 1)
        ms_new2 = cuda_ms(lambda: kx.flow_solve_fused_cuda(pk, area_, g_,
                                                           band=band), 1)
        print(f"  K11b at {label}: every mode bit-exact against its twin, A "
              f"against K7, vis against K8; "
              + "; ".join(f"{m}: {st['rounds']} rounds, {st['tiles_run']} "
                          f"tile visits, at most {st['max_inner_sweeps']} "
                          f"passes a visit, {st['launched']} launch, "
                          f"{st['host_reads']} host read, {st['blocks']} "
                          f"blocks" for m, st in notes.items())
              + f". 'both' {ms_new:.3f}, {ms_new2:.3f} ms; the earlier "
              f"design {ms_bands:.3f} ms ({sb['rounds']} rounds, "
              f"{sb['sweeps']} sweeps); K7+K8 {ms_k78:.3f} ms ({card})")
        return min(ms_new, ms_new2), ms_bands, ms_k78, notes["both"]

    def hold_new_k11(label, pk, area_, g_, earlier=None):
        """The redesigned K11a (TMA windows) and K11c (the wave blocked in
        time) against their twins (K11a's on the card's tiles), K7 (K11a's
        A) and K8 (both vis) bit for bit, one launch and one host read a
        solve; then timed in turns with K7+K8 and the earlier designs
        (CUDA events, one call each after a warm-up; the earlier K11a only
        where the reference's tiles divide the grid).  ``earlier``: the
        earlier designs' ms where the caller has timed them on these
        masks already.  Returns the numbers for the summary line."""
        A7 = kf.flow_solve_area_cuda(pk, area_, g_)
        vis8 = kf.vis_solve_cuda(pk, g_)
        before = (kx.LAUNCHES_2D_TMA, kx.LAUNCHES_WAVE_TILES)
        A, vis, sa = kx.flow_solve_2d_tma_cuda(pk, area_, g_)
        tA, tvis, sta = kx.flow_solve_2d_plain(pk, area_, g_, k=16,
                                               tiles=kf.TILE)
        torch.cuda.synchronize()
        assert sa["launched"] == sa["host_reads"] == 1, sa
        assert torch.equal(A, tA) and torch.equal(vis, tvis), label
        assert torch.equal(A, A7) and torch.equal(vis, vis8), label
        del A, vis, tA, tvis
        A, vis, sw = kx.flow_solve_wave_tiles_cuda(pk, area_, g_)
        wA, wvis, stw = kx.flow_solve_wave_plain(pk, area_, g_)
        torch.cuda.synchronize()
        assert (kx.LAUNCHES_2D_TMA, kx.LAUNCHES_WAVE_TILES) == (
            before[0] + 1, before[1] + 1)
        assert sw["launched"] == sw["host_reads"] == 1, sw
        assert torch.equal(A, wA) and torch.equal(vis, wvis), label
        assert torch.equal(vis, vis8), label
        assert sw["wave_depth"] < stw["sweeps"], (sw, stw)
        wave_err = max_err(A, A7) / float(A7.abs().max())
        del A, vis, wA, wvis, A7, vis8
        old_2d = kx.pick_tiles(*g_.shape)[0] and kx.pick_tiles(*g_.shape)[1]

        def k78():
            return kf.flow_solve_area_cuda(pk, area_, g_), \
                kf.vis_solve_cuda(pk, g_)

        ms = {"K7+K8": [cuda_ms(k78, 1)]}
        if earlier is not None:
            ms.update({n: [t] for n, t in earlier.items()})
        for turn in range(2):
            ms.setdefault("K11a", []).append(cuda_ms(
                lambda: kx.flow_solve_2d_tma_cuda(pk, area_, g_), 1))
            ms.setdefault("K11c", []).append(cuda_ms(
                lambda: kx.flow_solve_wave_tiles_cuda(pk, area_, g_), 1))
            if turn == 0 and earlier is None:
                if old_2d:
                    ms["K11a earlier"] = [cuda_ms(
                        lambda: kx.flow_solve_2d_cuda(pk, area_, g_), 1)]
                ms["K11c earlier"] = [cuda_ms(
                    lambda: kx.flow_solve_wave_cuda(pk, area_, g_), 1)]
        ms["K7+K8"].append(cuda_ms(k78, 1))

        def shares(st):
            """Each phase's share of the blocks' cycles, in percent."""
            c = st["block_kcycles"]
            return {n: round(100.0 * v / max(c["all"], 1), 1)
                    for n, v in c.items() if n != "all"}

        print(f"  K11a (TMA) at {label}: bit-exact against its twin on "
              f"{kf.TILE[0]}x{kf.TILE[1]} tiles ({sta['rounds']} rounds, "
              f"{sta['sweeps']} sweeps), A against K7, vis against K8; "
              f"{sa['rounds']} rounds, {sa['tiles_run']} visits, at most "
              f"{sa['max_inner_sweeps']} sweeps a visit, 1 launch, 1 host "
              f"read, {sa['blocks']} blocks. K11c (tiles) at {label}: A and "
              f"vis bit-exact against the twin, vis against K8, A against "
              f"K7 within {wave_err:.2e} of max; {sw['rounds']} rounds "
              f"({sw['wave_rounds']} with the wave), {sw['sweeps']} sweeps "
              f"(the last delta at sweep {sw['wave_depth']}, the twin "
              f"certifies at {stw['sweeps']}), wave tile-sweeps "
              f"{sw['wave_visits'] * sw['k']} against the twin's "
              f"{stw['sweeps']} x {sw['tiles']} = "
              f"{stw['sweeps'] * sw['tiles']}, {sw['vis_visits']} vis "
              f"visits, {sw['blocks']} blocks; the blocks' cycles (%): "
              f"K11a {shares(sa)}, K11c {shares(sw)}; ms "
              + json.dumps({k: [round(t, 3) for t in v]
                            for k, v in ms.items()}) + f" ({card})")
        return {"ms": {k: min(v) for k, v in ms.items()}, "K11a": sa,
                "K11c": sw, "twin_sweeps": stw["sweeps"],
                "delta_cells": stw["delta_cells"]}

    def hold_k11d(label, pk, area_, g_, twin=True):
        """The redesigned K11d (cluster windows, one launch a round,
        ``flow_tune``'s band 64 and k) against K7 and K8 (and its twin
        where ``twin``) bit for bit, one launch and one host read a
        round; then timed in turns with the earlier design (k 16 launches
        a round) and K7+K8 (CUDA events, one call each after a warm-up).
        Returns the numbers for the summary line."""
        band = 64
        A7 = kf.flow_solve_area_cuda(pk, area_, g_)
        vis8 = kf.vis_solve_cuda(pk, g_)
        before = (kx.LAUNCHES_BANDED, kx.LAUNCHES_BANDED_SWEEPS)
        A, vis, st = kx.flow_solve_banded_rounds(pk, area_, g_, band,
                                                 kx.BANDED_K)
        torch.cuda.synchronize()
        assert st["design"] == "cluster", st
        assert (kx.LAUNCHES_BANDED - before[0], kx.LAUNCHES_BANDED_SWEEPS
                - before[1]) == (st["launches"], 0), st
        assert st["launches"] == st["host_reads"] == st["rounds"], st
        assert st["cluster_runs"] == st["band_runs"] * st["segments"], st
        assert torch.equal(A, A7) and torch.equal(vis, vis8), label
        if twin:
            tA, tvis, _ = kx.flow_solve_banded_rounds_plain(
                pk, area_, g_, band, kx.BANDED_K)
            assert torch.equal(A, tA) and torch.equal(vis, tvis), label
            del tA, tvis
        A, vis, so = kx.flow_solve_banded_sweeps_cuda(pk, area_, g_, band,
                                                      16)
        torch.cuda.synchronize()
        assert torch.equal(A, A7) and torch.equal(vis, vis8), label
        del A, vis, A7, vis8

        def k78():
            return kf.flow_solve_area_cuda(pk, area_, g_), \
                kf.vis_solve_cuda(pk, g_)

        def new():
            return kx.flow_solve_banded_rounds_cuda(pk, area_, g_, band,
                                                    kx.BANDED_K)

        def old():
            return kx.flow_solve_banded_sweeps_cuda(pk, area_, g_, band, 16)

        ms = {"K7+K8": [cuda_ms(k78, 1)], "K11d": [cuda_ms(new, 1)],
              "K11d earlier": [cuda_ms(old, 1)]}
        ms["K11d"].append(cuda_ms(new, 1))
        ms["K7+K8"].append(cuda_ms(k78, 1))
        c = st["block_kcycles"]
        shares = {n: round(100.0 * v / max(sum(c.values()), 1), 1)
                  for n, v in c.items()}
        print(f"  K11d (cluster windows) at {label}: A against K7, vis "
              f"against K8 bit for bit{' and the twin' if twin else ''}; "
              f"band {band}, k {kx.BANDED_K}, clusters of {st['cluster']} "
              f"({st['clusters_at_once']} at once), {st['segments']} "
              f"segment(s) of {st['seg']} columns; a solve: {st['rounds']} "
              f"rounds, {st['launches']} launches, {st['host_reads']} host "
              f"reads, {st['band_runs']} band runs, {st['cluster_runs']} "
              f"cluster visits, at most {st['max_inner_sweeps']} sweeps a "
              f"window; the earlier design {so['rounds']} rounds, "
              f"{so['launches']} launches, {so['host_reads']} host reads; "
              f"the blocks' cycles (%): {shares}; ms "
              + json.dumps({k: [round(t, 3) for t in v]
                            for k, v in ms.items()}) + f" ({card})")
        return {"ms": {k: min(v) for k, v in ms.items()},
                "rounds": st["rounds"], "launches": st["launches"],
                "host_reads": st["host_reads"],
                "band_runs": st["band_runs"],
                "earlier_launches": so["launches"]}

    new_k11 = {f"{W}x{H}": hold_new_k11(
        f"{W}x{H}", pk10, of.cell_area_lower_edge(grid, dev), grid)}
    k11b_ms = {f"{W}x{H}": hold_k11b(f"{W}x{H}", pk10, of.cell_area_lower_edge(
        grid, dev), grid, 64)}
    g_r = Grid(*RAGGED)
    pk_r, area_r = flow_inputs(cli._terrain(g_r, SEED, dev), g_r)
    k11b_ms[f"{RAGGED[0]}x{RAGGED[1]}"] = hold_k11b(
        f"{RAGGED[0]}x{RAGGED[1]}", pk_r, area_r, g_r, 40)
    new_k11[f"{RAGGED[0]}x{RAGGED[1]}"] = hold_new_k11(
        f"{RAGGED[0]}x{RAGGED[1]}", pk_r, area_r, g_r)
    del pk_r, area_r
    k11d = {f"{W}x{H}": hold_k11d(f"{W}x{H}", pk10,
                                  of.cell_area_lower_edge(grid, dev), grid)}

    # K11a-d from flow_tune's rows: bit-exact against their twins there
    edges10 = float(sum(((pk10 >> i) & 1).sum() for i in range(8)))
    replaces = {"flow_solve_2d_tma": "attic/flow_deadends.py:115",
                "flow_solve_2d": "attic/flow_deadends.py:115",
                "flow_solve_fused": "attic/flow_deadends.py:319",
                "flow_solve_wave_tiles": "attic/flow_deadends.py:804",
                "flow_solve_wave": "attic/flow_deadends.py:804",
                "flow_banded_rounds": "tools/flow_rounds.py:24",
                "flow_banded_sweeps": "tools/flow_rounds.py:24"}
    earlier = {"flow_solve_2d": "K11a's earlier design, the yardstick off "
                                "every path: an activity pass and k "
                                "one-sweep launches a round",
               "flow_banded_sweeps": "K11d's earlier design, the yardstick "
                                     "off every path: k one-sweep launches "
                                     "a round",
               "flow_solve_wave": "K11c's earlier design, the yardstick off "
                                  "every path: one launch a sweep of every "
                                  "pixel"}
    k78_ms = tune_rows[0]["ms"]
    split_row = next(r for r in tune_rows if "split" in r["label"])
    for name, where in replaces.items():
        row = next(r for r in tune_rows if r["kernel"] == name)
        note = (f"{row['label']}: bit-exact against its twin; against K7: "
                f"{row['differ']} A cells differ, vis equal to K8; stats "
                f"{row['stats']}; K7+K8 {k78_ms:.3f} ms")
        if name == "flow_solve_fused":
            new_ms, bands_ms, _, _ = k11b_ms[f"{W}x{H}"]
            note += (f"; split A then vis {split_row['ms']:.3f} ms; one "
                     f"call on the same masks {new_ms:.3f} ms, the earlier "
                     f"design {bands_ms:.3f} ms")
        if name == "flow_banded_rounds":
            d = k11d[f"{W}x{H}"]
            note += (f"; a solve {d['launches']} launches and "
                     f"{d['host_reads']} host reads (the earlier design "
                     f"{d['earlier_launches']} launches); one call on the "
                     f"same masks {d['ms']['K11d']:.3f} ms, the earlier "
                     f"design {d['ms']['K11d earlier']:.3f} ms, K7+K8 "
                     f"{d['ms']['K7+K8']:.3f} ms")
        if name in earlier:
            note = f"{earlier[name]}; {note}"
        flops = edges10 + N
        if name == "flow_solve_wave_tiles":
            # the wave's own work: 8 adds and A's add on each cell with a
            # nonzero delta, summed over the twin's sweeps
            flops = 9.0 * new_k11[f"{W}x{H}"]["delta_cells"]
        record(name, "demiurge_tpu_torch/csrc/flow_deadends.cu", where, 0.0,
               row["ms"], row["twin_ms"], 3 * plane + N, flops, note)
    new_ms, bands_ms, _, _ = k11b_ms[f"{W}x{H}"]
    record("flow_solve_fused_bands", "demiurge_tpu_torch/csrc/flow_deadends.cu",
           "attic/flow_deadends.py:319", 0.0, bands_ms,
           next(r for r in tune_rows
                if r["kernel"] == "flow_solve_fused")["twin_ms"],
           3 * plane + N, edges10 + N,
           "K11b's earlier design, the yardstick off every path: band "
           "windows, one pixel a thread, one grid sync a sweep, 'both' on "
           "flow_tune's masks")
    del pk10

    def timed(fn):
        """(fn(), device ms of that one call)."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # at the coupled CLI's default size, against K7/K8 only
    hb_big = ob.blur(cli._terrain(big_grid, SEED, dev), big_grid,
                     ccfg.flow_preblur)
    code_big = of.flow_directions(hb_big, torch.ones_like(hb_big), big_grid)
    _, mouth_big, _ = of.incoming_mask(code_big, big_grid)
    pk_big = kf.pack_masks(code_big, mouth_big, big_grid)
    area_big = of.cell_area_lower_edge(big_grid, dev)
    del hb_big, code_big, mouth_big
    big_solvers = ft.solvers(pk_big, area_big, big_grid)
    (A7b, vis8b, st7b), ms7b = timed(big_solvers[0][2])
    big_ms = {"K7+K8": round(ms7b, 3)}
    print(f"  K7+K8 at {BIG[0]}x{BIG[1]}: {ms7b:.3f} ms (one call); K7 "
          f"{solve_note(st7b['A'])}; K8 {solve_note(st7b['vis'])}")
    for label, _, solve, _, exact in big_solvers[1:]:
        (A, vis, st), ms_b = timed(solve)
        assert ft.agrees(A, vis, A7b, vis8b, exact), label
        big_ms[label] = round(ms_b, 3)
        print(f"  {label} at {BIG[0]}x{BIG[1]}: against K7 "
              f"{int((A != A7b).sum())} A cells differ, vis equal to K8; "
              f"{ms_b:.3f} ms (one call); stats "
              f"{ {k: v for k, v in st.items() if k != 'active'} }")
        del A, vis
    del A7b, vis8b
    k11b_ms[f"{BIG[0]}x{BIG[1]}"] = hold_k11b(f"{BIG[0]}x{BIG[1]}", pk_big,
                                              area_big, big_grid, 128)
    big_ms["K11b fused both, held"] = round(k11b_ms[
        f"{BIG[0]}x{BIG[1]}"][0], 3)
    big_ms["K11b earlier design"] = round(k11b_ms[f"{BIG[0]}x{BIG[1]}"][1], 3)
    new_k11[f"{BIG[0]}x{BIG[1]}"] = hold_new_k11(
        f"{BIG[0]}x{BIG[1]}", pk_big, area_big, big_grid, earlier={
            "K11a earlier": big_ms["K11a earlier: a launch a sweep, k=16"],
            "K11c earlier": big_ms["K11c earlier: a launch a sweep"]})
    k11d[f"{BIG[0]}x{BIG[1]}"] = hold_k11d(f"{BIG[0]}x{BIG[1]}", pk_big,
                                          area_big, big_grid, twin=False)
    print(f"K11 at {BIG[0]}x{BIG[1]} (one call each, CUDA events, {card}): "
          f"{json.dumps(big_ms)}")
    print(f"K11d on cluster windows (the least ms of each over one-call "
          f"timings in turns; a solve's rounds, launches, host reads, band "
          f"runs) a size ({card}): " + json.dumps(k11d))
    print(f"K11b (ms, the earlier design's ms, K7+K8 ms, rounds) a size "
          f"({card}): " + json.dumps({
              k: [round(a, 3), round(b, 3), round(c, 3), st["rounds"]]
              for k, (a, b, c, st) in k11b_ms.items()}))
    print(f"K11a and K11c redesigned (the least ms of each over one-call "
          f"timings; rounds, visits, sweeps) a size ({card}): " + json.dumps({
              k: {"ms": {n: round(t, 3) for n, t in v["ms"].items()},
                  "K11a": [v["K11a"]["rounds"], v["K11a"]["tiles_run"],
                           v["K11a"]["max_inner_sweeps"]],
                  "K11c": [v["K11c"]["rounds"], v["K11c"]["wave_visits"],
                           v["K11c"]["vis_visits"], v["K11c"]["sweeps"],
                           v["K11c"]["wave_depth"], v["K11c"]["tiles"]],
                  "twin_sweeps": v["twin_sweeps"],
                  "delta_cells": v["delta_cells"]}
              for k, v in new_k11.items()}))
    del pk_big, area_big
    torch.cuda.empty_cache()
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s")

    # -- 10. BASELINE config 1: the erosion CLI, counted -------------------
    from demiurge_tpu_torch.core.platform import host_to_device
    from demiurge_tpu_torch.native import build as nbuild
    from demiurge_tpu_torch.native import lakes as nlakes
    from demiurge_tpu_torch.ops import tectonics as ot

    t0 = time.perf_counter()
    native_lib, gxx_s = nbuild.build()
    nbuild.library()
    print(f"built {native_lib.name}: g++ {gxx_s:.1f} s, build+load "
          f"{time.perf_counter() - t0:.1f} s")

    def erosion_cli(cmd, size, steps):
        """The erosion command ``cmd`` at ``size`` for ``steps`` with every
        counter at 0; fails unless K5 and K6's codes form launched once a
        step (the packed form never), K12 once a sweep of every step's
        relaxation, the native solver ran once a step, and every logged
        mass and the field are finite.  Returns (field, each form's
        launches, seconds with the terrain)."""
        solves = []   # each relaxation's launches of K12's three kernels
        stencil = of.flow_solve_stencil

        def counted_solve(*args, **kwargs):
            launches0 = read_counts(lake_tiles)
            out = stencil(*args, **kwargs)
            st = of.LAST_SOLVE
            solves.append([(st[f]["rounds"], st[f]["launched"])
                           for f in ("A", "vis", "root")])
            assert list(solves[-1][i][1] for i in range(3)) == [
                n - launches0[k]
                for k, n in read_counts(lake_tiles).items()], solves
            return out

        zero_counts()
        native0 = nlakes.CALLS
        log_text = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log_text), mock.patch.object(
                of, "flow_solve_stencil", counted_solve):
            out = cli.main([cmd, "--steps", str(steps)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        forms = own_forms(read_counts(list(counters)))
        native_calls = nlakes.CALLS - native0
        records = [json.loads(line)
                   for line in log_text.getvalue().splitlines()
                   if line.startswith("{")]
        for rec in records:
            print("cli:", json.dumps(rec))
        fired = {k: v for k, v in forms.items() if v}
        print(f"launches on the {cmd} path ({steps} steps at "
              f"{size[0]}x{size[1]}): {json.dumps(fired)}; native lake "
              f"solves {native_calls}; K12's (rounds, launches) of A, vis "
              f"and root a step {solves}; {secs:.2f} s with the terrain")
        assert [r["step"] for r in records] == list(range(steps)), \
            log_text.getvalue()
        for rec in records:
            assert isinstance(rec["mass"], float) and \
                math.isfinite(rec["mass"])
        assert len(solves) == steps and all(
            0 < rounds <= launched for st in solves for rounds, launched in st
        ), solves
        assert fired == {"blur": steps, "flow_directions": steps,
                         **{k: sum(st[i][1] for st in solves)
                            for i, k in enumerate(lake_tiles)}}, fired
        assert native_calls == steps, native_calls
        h = out["terrain"]
        assert tuple(h.shape) == (size[1], size[0])
        assert bool(torch.isfinite(h).all())
        return h, forms, secs

    def against_twins(name, h, loop, egrid, sel, steps):
        """``loop(callback)`` through the plain twins: the height beyond
        1e-5 of max at no more than 1e-3 of the pixels; direction ties
        counted a step on the twins' heights."""
        ties = []

        def count_ties(i, hh):
            hbk = kb.blur_cuda(hh, egrid, ob.sigma_list(0.5))
            ties.append(int((kd.flow_directions_cuda(hbk, sel, egrid)
                             != kd.flow_directions_plain(hbk, sel, egrid))
                            .sum()))

        with plain_twins():
            h_ref = loop(count_ties)
        torch.cuda.synchronize()
        dh = (h - h_ref).abs() / h_ref.abs().max()
        share = float((dh > 1e-5).float().mean())
        print(f"  {steps} {name} steps, height: kernel path against the "
              f"plain twins err/max {float(dh.max()):.3e}, share beyond "
              f"1e-5 of max {share:.3e} (bound 1e-3); direction ties per "
              f"step on the twins' heights {ties}")
        assert share <= 1e-3, share

    FLOW_STAGES = ["pre-blur + directions + masks (K5, K6 codes form)",
                   "host lake solve (copies, native solver)",
                   "lake-aware relaxation (K12's tiled solve)",
                   "flow map + erosion pass"]
    TECTO_STAGE = "tectonic uplift (plain torch; steps 0 and 5)"

    def staged(egrid, terrain, sel, ecfg, steps, tectonic_every=None):
        """The erosion loop written out stage by stage, each stage timed
        on the host clock around a synchronize (the lake solve and the
        relaxation's checks wait for the device anyway); with
        ``tectonic_every``, config 2's tectonic uplift first where it
        refreshes.  Returns (h, {stage: [ms]}, K12's launches and host
        reads a solve, connections, the first iteration's relaxation
        inputs)."""
        uplift0, h = erosion.init_uplift(terrain, ecfg)
        uplift = uplift0
        fcfg = of.FlowConfig(preblur=0.5, exponent=ecfg.exponent,
                             lakes=True)
        split = {k: [] for k in FLOW_STAGES}
        if tectonic_every:
            stack = ot.init_plate_stack(terrain, egrid)
            split = {TECTO_STAGE: [], **split}
        sweeps, n_conn, first = [], [], None
        for i in range(steps):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            if tectonic_every and i % tectonic_every == 0:
                stack, tup = ot.tectonic_uplift(stack, egrid)
                uplift = uplift0 + tup
                torch.cuda.synchronize()
                split[TECTO_STAGE].append((time.perf_counter() - t[0]) * 1e3)
                t = [time.perf_counter()]
            hbs = ob.blur(h, egrid, fcfg.preblur)
            code = of.flow_directions(hbs, sel, egrid)
            mask, mouth, _ = of.incoming_mask(code, egrid)
            parent = of.parent_pointers(code, egrid)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            sol = nlakes.solve_lakes_native(
                mask.cpu().numpy().reshape(-1),
                mouth.cpu().numpy().reshape(-1),
                h.cpu().numpy().reshape(-1), parent.cpu().numpy(), egrid)
            cfrom = host_to_device(sol.conn_from, dev)
            cto = host_to_device(sol.conn_to, dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            area = of.cell_area_lower_edge(egrid, dev, fcfg.area_scale)
            acc, vis, root = of.flow_solve_stencil(
                code, area, mouth, egrid, conn_from=cfrom, conn_to=cto,
                want_root=True)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            st = of.LAST_SOLVE
            sweeps.append((sum(v["launched"] for v in st.values()),
                           max(v["host_reads"] for v in st.values())))
            n_conn.append(int(sol.conn_from.size))
            if first is None:
                first = (code, mouth, area, cfrom, cto)
            fm = torch.where(vis, torch.pow(acc, fcfg.exponent), -1.0)
            wh = host_to_device(np.nan_to_num(sol.lake_wh, nan=-np.inf),
                                dev)
            cell_wh = torch.where(root >= 0, wh[torch.clamp(root, min=0)],
                                  -math.inf)
            fm = torch.where(vis & (h <= cell_wh), 0.0, fm)
            h = erosion.erosion_pass(h, fm, uplift, egrid, ecfg.factor,
                                     ecfg.slope_exponent)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for k, t0_, t1_ in zip(FLOW_STAGES, t, t[1:]):
                split[k].append((t1_ - t0_) * 1e3)
        return h, split, sweeps, n_conn, first

    def print_split(title, split, steps, sweeps, n_conn, cli_s):
        """Each stage's mean ms an iteration (a stage that runs on some
        iterations only is spread over all) and its share."""
        iter_ms = sum(sum(v) for v in split.values()) / steps
        print(f"{title} ({steps} iterations stage by stage, host clock "
              f"around a synchronize; equal to the CLI's field; {card}): "
              f"{iter_ms:.2f} ms an iteration; the CLI "
              f"{cli_s * 1e3 / steps:.2f} ms a step with its terrain")
        for k, v in split.items():
            m = sum(v) / steps
            print(f"  {k:52s} {m:9.2f} ms  {100 * m / iter_ms:5.1f}%  "
                  f"{json.dumps([round(x, 2) for x in v])}")
        print(f"  K12's (launches, host reads) a step {sweeps}, "
              f"{split[FLOW_STAGES[2]][-1] * 1e3 / sweeps[-1][0]:.2f} us a "
              f"launch in the last; lake connections a step {n_conn}")

    def relax_inputs(egrid, h, sel):
        """One relaxation's inputs on ``h``, as the flow filter makes
        them: (code, mouth, area, conn_from, conn_to)."""
        code = of.flow_directions(ob.blur(h, egrid, 0.5), sel, egrid)
        mask, mouth, _ = of.incoming_mask(code, egrid)
        parent = of.parent_pointers(code, egrid)
        sol = nlakes.solve_lakes_native(
            mask.cpu().numpy().reshape(-1), mouth.cpu().numpy().reshape(-1),
            h.cpu().numpy().reshape(-1), parent.cpu().numpy(), egrid)
        return (code, mouth, of.cell_area_lower_edge(egrid, dev),
                host_to_device(sol.conn_from, dev),
                host_to_device(sol.conn_to, dev))

    def same_bits(a, b):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.dtype == b.dtype and torch.equal(a, b)

    def events_ms(fn):
        """(fn(), its milliseconds between CUDA events), no warm-up."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def tile_note(stats):
        """A tiled K12 solve's stats by field, in words."""
        return "; ".join(f"{f} {solve_note(st)}" for f, st in stats.items())

    def hold_k12(label, egrid, inputs, record_it=False):
        """K12 on one relaxation's inputs.  The tiled solve (the main
        path's ``flow_solve_stencil``) against the twin's solve: A, vis
        and root bit for bit, its rounds, launches, host reads and tile
        visits printed; the one-sweep kernel against the twin after 1, 7
        and 64 sweeps from the solve's start, and its Jacobi solve bit for
        bit with the same sweeps as the twin's.  Times (CUDA events): the
        three solves through ``flow_solve_stencil``, each tiled kernel's
        solve alone, a one-sweep launch queued ahead of the host
        (``device_ms``, 64 a call) and a twin sweep."""
        code, mouth, area, cfrom, cto = inputs
        src, dst = kl.conn_fields(cfrom, cto, egrid.shape)
        packed = kl.pack_lake_masks(code, mouth, egrid, src, dst)
        hh, ww = egrid.shape
        start = (packed, area, src, dst, area, mouth, kl.root_start(packed),
                 egrid)
        for n in (1, 7, 64):
            got = kl.relax_sweep_cuda(*start, n)
            want = kl.relax_sweep_twin(*start, n)
            for name, g, w in zip(("A", "vis", "root"), got, want):
                assert same_bits(g, w), f"K12 {label}: {name}, {n} sweeps"

        def solve():
            return of.flow_solve_stencil(code, area, mouth, egrid,
                                         conn_from=cfrom, conn_to=cto,
                                         want_root=True)

        def one_sweep_solve(*args):
            return kl.jacobi_solve(kl.relax_sweep_cuda, *args)

        before = read_counts(["lake_relax", *lake_tiles])
        got = solve()
        stats = dict(of.LAST_SOLVE)
        after = read_counts(["lake_relax", *lake_tiles])
        assert after["lake_relax"] == before["lake_relax"]
        assert [after[k] - before[k] for k in lake_tiles] == [
            stats[f]["launched"] for f in ("A", "vis", "root")], stats
        with mock.patch.object(kl, "relax_solve", kl.relax_solve_twin):
            want, twin_ms = events_ms(solve)
            sweeps = of.LAST_SOLVE["sweeps"]
        for name, g, w in zip(("A", "vis", "root"), got, want):
            assert same_bits(g, w), f"K12 {label}: the tiled solve's {name}"
        with mock.patch.object(kl, "relax_solve", one_sweep_solve):
            launches0 = kl.LAUNCHES
            old = solve()
            launched = kl.LAUNCHES - launches0
            assert launched == of.LAST_SOLVE["sweeps"] == sweeps, (
                launched, sweeps)
            old_ms = cuda_ms(solve, 3)
        for name, g, w in zip(("A", "vis", "root"), old, want):
            assert same_bits(g, w), f"K12 {label}: the one-sweep {name}"
        solve_ms = cuda_ms(solve, 3)
        part_ms = {f: cuda_ms(lambda f=f: kl.tile_solves(
            packed, area, src, dst, egrid, (f,)), 3) for f in stats}
        sweep_ms = device_ms(lambda: kl.relax_sweep_cuda(*start, 64),
                             10) / 64
        twin_sweep_ms = cuda_ms(lambda: kl.relax_sweep_twin(*start), 10)
        cells, conns = hh * ww, int(cfrom.numel())
        adds = sum(int(((packed >> i) & 1).sum()) for i in range(8)) + conns
        # what a sweep must move: packed, area, A and root (4 B each) and
        # vis (1 B) read, A, vis and root written, and the two int64
        # connection lists (16 B a connection); the whole solve reads
        # packed, area and the lists once and writes A, vis and root once;
        # each tiled kernel alone: packed and its own field (A also the
        # area), with the lists where it reads them
        sweep_bytes = 26.0 * cells + 16.0 * conns
        sweep_bound = bound(sweep_bytes, adds)
        solve_bound = bound(17.0 * cells + 16.0 * conns, adds)
        part_work = {"A": (12.0 * cells + 16.0 * conns, adds),
                     "vis": (5.0 * cells + 16.0 * conns, 0),
                     "root": (8.0 * cells, 0)}
        print(f"K12, {label} ({ww}x{hh}, {conns} connections, "
              f"{'x-periodic' if egrid.wrap_x else 'regional'}): the tiled "
              f"solve bit for bit against the twin's ({sweeps} sweeps), "
              f"{tile_note(stats)}; the one-sweep kernel bit for bit after "
              f"1, 7, 64 sweeps and over its solve ({launched} launches). "
              f"Solve through flow_solve_stencil: tiled {solve_ms:.3f} ms, "
              f"one-sweep {old_ms:.3f} ms, twin {twin_ms:.3f} ms, bound "
              f"{solve_bound[0]:.4f} ms ({solve_bound[1]}); each tiled "
              f"kernel's solve alone "
              f"{json.dumps({f: round(v, 3) for f, v in part_ms.items()})}"
              f" ms; a one-sweep launch {sweep_ms * 1e3:.2f} us, twin "
              f"{twin_sweep_ms:.3f} ms, bound {sweep_bound[0] * 1e3:.2f} us "
              f"({sweep_bound[1]}) ({card})")
        if record_it:
            for f, name in zip(("A", "vis", "root"), lake_tiles):
                record(name, "demiurge_tpu_torch/csrc/lakeflow.cu",
                       "demiurge_tpu/ops/flow.py:342",
                       max_err(got[("A", "vis", "root").index(f)],
                               want[("A", "vis", "root").index(f)]),
                       part_ms[f], twin_ms, *part_work[f],
                       f"K12's tiled {f} solve alone at {ww}x{hh} "
                       f"({conns} connections; {solve_note(stats[f])}; the "
                       f"plain time is the twin's solve of all three "
                       f"fields; the whole tiled solve {solve_ms:.3f} ms)")
            record("lake_relax", "demiurge_tpu_torch/csrc/lakeflow.cu",
                   "demiurge_tpu/ops/flow.py:342", max_err(old[0], want[0]),
                   sweep_ms, twin_sweep_ms, sweep_bytes, adds,
                   f"the one-sweep kernel, off the main path: one sweep at "
                   f"{ww}x{hh} (its solve {sweeps} sweeps, {old_ms:.3f} ms "
                   f"against the twin's {twin_ms:.3f} ms)")

    ESTEPS = 5
    egrid = Grid(*ERODE)
    h_ero, erosion_forms, ero_cli_s = erosion_cli("erosion", ERODE, ESTEPS)
    e_terrain = cli._terrain(egrid, SEED, dev)
    e_sel = torch.ones(egrid.shape, device=dev)
    ecfg = erosion.ErosionConfig(lakes=True)
    against_twins("erosion", h_ero, lambda cb: erosion.landscape_evolution(
        e_terrain, e_sel, egrid, ecfg, iterations=ESTEPS, callback=cb),
        egrid, e_sel, ESTEPS)
    h_s, split, sweeps, n_conn, first = staged(egrid, e_terrain, e_sel,
                                               ecfg, ESTEPS)
    assert torch.equal(h_s, h_ero), "the staged iterations left the CLI's"
    print_split(f"erosion iteration at {ERODE[0]}x{ERODE[1]}, BASELINE "
                f"config 1", split, ESTEPS, sweeps, n_conn, ero_cli_s)
    # K12 on config 1's first relaxation, without its connections, on a
    # 2000x1000 grid that neither the tiles nor 256-column blocks divide,
    # and on a regional 300x12 grid (the column clamps), the CLI's terrain
    # on both
    hold_k12("config 1, first iteration", egrid, first)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    hold_k12("config 1, first iteration, 0 connections", egrid,
             (*first[:3], none, none))
    for label, kgrid in (("the erosion CLI's terrain", Grid(*RAGGED)),
                         ("the erosion CLI's terrain, regional",
                          Grid(300, 12, REGIONAL))):
        hold_k12(label, kgrid, relax_inputs(
            kgrid, cli._terrain(kgrid, SEED, dev),
            torch.ones(kgrid.shape, device=dev)))
    del first
    del h_ero, h_s, e_terrain
    torch.cuda.empty_cache()

    # -- 10b. BASELINE config 2: the tectonic-erosion CLI, counted ------
    TSTEPS = 6          # the uplift refreshes at steps 0 and 5
    TEVERY = 5          # the CLI's tectonic_every
    tgrid = Grid(*TECTO)
    h_tec, tecto_forms, tec_cli_s = erosion_cli("tectonic-erosion", TECTO,
                                                TSTEPS)
    t_terrain = cli._terrain(tgrid, SEED, dev)
    t_sel = torch.ones(tgrid.shape, device=dev)
    against_twins("tectonic-erosion", h_tec,
                  lambda cb: erosion.coupled_tectonic_erosion(
                      t_terrain, t_sel, tgrid, ecfg, iterations=TSTEPS,
                      tectonic_every=TEVERY, callback=cb),
                  tgrid, t_sel, TSTEPS)
    h_s, split, sweeps, n_conn, first = staged(
        tgrid, t_terrain, t_sel, ecfg, TSTEPS, tectonic_every=TEVERY)
    assert torch.equal(h_s, h_tec), "the staged iterations left the CLI's"
    print_split(f"tectonic-erosion iteration at {TECTO[0]}x{TECTO[1]}, "
                f"BASELINE config 2", split, TSTEPS, sweeps, n_conn,
                tec_cli_s)
    hold_k12("config 2, first iteration", tgrid, first, record_it=True)
    del first
    tec_ms = split[TECTO_STAGE]
    stack = ot.init_plate_stack(t_terrain, tgrid)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ot.tectonic_uplift(stack, tgrid)
        torch.cuda.synchronize()
    tec_kernels = sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"a tectonic step {sum(tec_ms) / len(tec_ms):.2f} ms (host clock, "
          f"mean of {len(tec_ms)}); device kernels, copies and fills in one "
          f"(torch.profiler): {tec_kernels}")
    del h_tec, h_s, t_terrain, stack
    torch.cuda.empty_cache()

    # -- 12. the editor session at 2048x1024, counted --------------------
    from demiurge_tpu_torch.api import Project
    from demiurge_tpu_torch.ops import noise as onoise
    from demiurge_tpu_torch.ops import pressure_cg as ocg
    from demiurge_tpu_torch.ops.brush import BrushParams

    # the session's PNG and npz go to a directory of the checkout that is
    # removed at the end of the phase
    out_tmp = tempfile.TemporaryDirectory(dir=REPO, prefix=".phase12_")
    out_dir = pathlib.Path(out_tmp.name)
    OTHER_MODES = ("default", "billowy", "iq", "swiss", "jordan",
                   "plateaus")
    # ten points across the dateline, within 10 degrees of the north pole
    STROKE = [(0.88, 0.80), (0.92, 0.86), (0.96, 0.91), (0.99, 0.945),
              (0.02, 0.95), (0.05, 0.94), (0.08, 0.92), (0.11, 0.89),
              (0.14, 0.86), (0.17, 0.83)]
    LASSO = [(0.10, 0.20), (0.50, 0.30), (0.45, 0.80), (0.20, 0.70),
             (0.15, 0.40)]

    def noise_layers(p):
        for i, mode in enumerate(OTHER_MODES):
            p.add_layer(mode, onoise.gradient_noise(
                p.terrain, p.sel, p.grid, onoise.NoiseParams(
                    mode=mode, octaves=8, scale=2.0, min=-4.0, max=6.0,
                    seed=11 + i, warp=0.5)))

    # (name, step); from "flow map" on the steps depend on the flow routing
    SESSION = [
        ("ridged noise", lambda p: p.gradient_noise(onoise.NoiseParams(
            mode="ridged", octaves=8, scale=1.5, min=-4.0, max=6.0,
            seed=SEED))),
        ("six other modes into layers", noise_layers),
        ("brush stroke", lambda p: p.brush_stroke(STROKE, BrushParams(
            size=40.0, value=0.8, hardness=0.3))),
        ("select height", lambda p: p.select_height(0.0, 3.0)),
        ("select lasso", lambda p: p.select_lasso(LASSO, "add")),
        ("select grow 8", lambda p: p.select_grow(8)),
        ("select border 4", lambda p: p.select_border(4)),
        ("select blur 2", lambda p: p.select_blur(2)),
        ("select all", lambda p: p.select_all()),
        ("blur 2.0", lambda p: p.blur(2.0)),
        ("thermal erosion 1", lambda p: p.thermal_erosion(1)),
        ("morphology 5 max", lambda p: p.morphology(5, "max")),
        ("offset -1.5", lambda p: p.offset(-1.5)),
        ("scale 1.2", lambda p: p.scale(1.2)),
        ("quantise to 0.25", lambda p: p._apply_terrain(
            torch.round(p.terrain / 0.25) * 0.25)),
        ("deterrace", lambda p: p.deterrace()),
        ("flow map", lambda p: p.flow_map()),
        ("undo flow map", lambda p: p.undo()),
        ("landscape evolution 2", lambda p: p.landscape_evolution(
            iterations=2)),
        ("ocean (Jacobi 1000)", lambda p: p.ocean_currents(1)),
        ("ocean (CG)", lambda p: p.ocean_currents(1, ocean.OceanConfig(
            pressure_method="cg"))),
        ("temperature 10", lambda p: p.temperature_sim(
            10, write_terrain=False)),
        ("tectonics 2", lambda p: p.tectonics(steps=2)),
        ("export png", lambda p: p.export_png(out_dir / "session.png")),
        ("save", lambda p: p.save(out_dir / "session.npz")),
    ]
    FLOW_FROM = [n for n, _ in SESSION].index("flow map")
    IO_STEPS = ("export png", "save")

    def run_session(io=True):
        """The session forward (without the export and the save unless
        ``io``); each step timed on the host clock around a synchronize.
        Returns (project, [(name, ms, terrain, sel)], the CG
        iterations)."""
        p = Project(*TECTO, device=DEVICE)
        rows = []
        cg_iters = None
        for name, step in SESSION:
            if name in IO_STEPS and not io:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(p)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if name == "ocean (CG)":
                cg_iters = ocg.LAST_SOLVE["iterations"]
            rows.append((name, ms, p.terrain.clone(), p.sel.clone()))
        return p, rows, cg_iters

    phase_t0 = time.perf_counter()
    zero_counts()
    p12, rows, cg_iters = run_session()
    session_forms = own_forms(read_counts(list(counters)))
    fired = {k: v for k, v in session_forms.items() if v}
    sess_ms = sum(r[1] for r in rows)
    print(f"editor session at {TECTO[0]}x{TECTO[1]} ({card}): "
          f"{sess_ms:.1f} ms, host clock around a synchronize a step; "
          f"launches {json.dumps(fired)}; CG iterations {cg_iters}")
    for name, ms, _, _ in rows:
        print(f"  {name:32s} {ms:10.2f} ms  {100 * ms / sess_ms:5.1f}%")
    for name in ("climate", "jacobi_pressure", "jacobi_diffusion",
                 "advect_stage", "ocean_project", "blur", "flow_directions",
                 *lake_tiles):
        assert session_forms[name] > 0, f"{name} never launched"
    assert session_forms["flow_directions_packed"] == 0, session_forms
    assert session_forms["lake_relax"] == 0, session_forms

    # finite fields; the saved checkpoint loads back exactly
    for name, _, t, s in rows:
        assert bool(torch.isfinite(t).all()) and bool(
            torch.isfinite(s).all()), name
    for f in (*p12.ocean_uv, p12.temperature,
              *(l.data for l in p12.layers.values())):
        assert bool(torch.isfinite(f).all())
    q = Project.load(out_dir / "session.npz", device=DEVICE)
    assert torch.equal(q.terrain, p12.terrain) and torch.equal(q.sel,
                                                                p12.sel)
    assert sorted(q.layers) == sorted(p12.layers)
    for lid, layer in p12.layers.items():
        assert q.layers[lid].name == layer.name
        assert torch.equal(q.layers[lid].data, layer.data)
    assert q.grid == p12.grid
    npz_mb = (out_dir / "session.npz").stat().st_size / 1e6
    print(f"  saved and loaded back exactly: {npz_mb:.1f} MB npz, "
          f"{len(q.layers)} layers")
    del q

    # direction ties at the flow steps' inputs (K6 against its twin on the
    # same blurred terrain), counted after the counters were read
    ties = []
    for k in (FLOW_FROM - 1, FLOW_FROM + 1):
        hb = kb.blur_cuda(rows[k][2], p12.grid, ob.sigma_list(0.5))
        ties.append(int((kd.flow_directions_cuda(hb, rows[k][3], p12.grid)
                         != kd.flow_directions_plain(hb, rows[k][3],
                                                     p12.grid)).sum()))

    # the same session through the plain twins, step by step
    twin_t0 = time.perf_counter()
    with plain_twins():
        p_twin, twin_rows, _ = run_session(io=False)
    for k, ((name, _, t, s), (_, _, t_ref, s_ref)) in enumerate(
            zip(rows, twin_rows)):
        for field, got, want in (("terrain", t, t_ref), ("sel", s, s_ref)):
            scale = max(float(want.abs().max()), 1e-30)
            off = (got - want).abs() > 1e-5 * scale
            share = float(off.float().mean())
            if k < FLOW_FROM:
                assert share == 0.0, (name, field, share)
            else:
                assert share <= 1e-3, (name, field, share)
    for got, want in zip((*p12.ocean_uv, p12.temperature),
                         (*p_twin.ocean_uv, p_twin.temperature)):
        scale = float(want.abs().max())
        share = float(((got - want).abs() > 1e-4 * scale).float().mean())
        assert share <= 1e-3, share
    dh = (rows[-1][2] - twin_rows[-1][2]).abs() / twin_rows[-1][2].abs().max()
    print(f"  kernel session against the plain-twin session: before the "
          f"flow map every step within 1e-5 of max; final terrain err/max "
          f"{float(dh.max()):.3e}, share beyond 1e-5 of max "
          f"{float((dh > 1e-5).float().mean()):.3e} (bound 1e-3); direction "
          f"ties at the flow map's and the erosion's inputs {ties}")
    del p_twin, twin_rows

    # undo everything, redo everything: back to 0 (selection 1), then back
    # to the final terrain, within the codec's accumulated accuracy
    n_entries = len(p12.undo_stack)
    undo_bytes = sum(e.nbytes for e in p12.undo_stack)
    final_t, final_s = p12.terrain.clone(), p12.sel.clone()
    scale = max(float(r[2].abs().max()) for r in rows)
    tol = n_entries * (1e-6 + 4 * 1.2e-7 * max(scale, 1.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while p12.undo():
        pass
    torch.cuda.synchronize()
    undo_s = time.perf_counter() - t0
    undo_err = (float(p12.terrain.abs().max()),
                float((p12.sel - 1).abs().max()))
    t0 = time.perf_counter()
    while p12.redo():
        pass
    torch.cuda.synchronize()
    redo_s = time.perf_counter() - t0
    redo_err = (float((p12.terrain - final_t).abs().max()),
                float((p12.sel - final_s).abs().max()))
    cells = p12.grid.width * p12.grid.height
    print(f"  undo history: {n_entries} entries, {undo_bytes} bytes "
          f"compressed ({undo_bytes / n_entries / cells:.4f} bytes a cell "
          f"an entry, against 4 raw); undo all {undo_s:.2f} s, |terrain|, "
          f"|sel - 1| after it {undo_err}; redo all {redo_s:.2f} s, off "
          f"the final {redo_err} (bound {tol:.2e})")
    assert max(undo_err) <= tol and max(redo_err) <= tol

    # the session's device kernels: a replay under torch.profiler without
    # the flow map, its undo and the erosion (the relaxation launches ~110
    # kernels a sweep for ~1400 sweeps a filter, too many events to trace
    # here) and without the export and the save (host work)
    prof_t0 = time.perf_counter()
    p_prof = Project(*TECTO, device=DEVICE)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for k, (name, step) in enumerate(SESSION):
            if not (FLOW_FROM <= k <= FLOW_FROM + 2 or name in IO_STEPS):
                step(p_prof)
        torch.cuda.synchronize()
    session_kernels = sum(1 for e in prof.events() if e.device_type
                          == torch.autograd.DeviceType.CUDA)
    print(f"  device kernels, copies and fills of the session without the "
          f"flow map, its undo, the erosion, the export and the save "
          f"(torch.profiler): {session_kernels}")
    now = time.perf_counter()
    print(f"phase 12 took {now - phase_t0:.1f} s: the kernel session, its "
          f"checks and the ties {twin_t0 - phase_t0:.1f} s, the twin "
          f"session, undo and redo {prof_t0 - twin_t0:.1f} s, the profiled "
          f"replay {now - prof_t0:.1f} s")
    del p_prof, rows
    out_tmp.cleanup()
    torch.cuda.empty_cache()

    # -- 13. render, checkpoints and the examples, counted ------------------
    from demiurge_tpu_torch.model import CoupledState
    from demiurge_tpu_torch.utils import checkpoint as ckpt
    from demiurge_tpu_torch.utils.png import read_png
    from demiurge_tpu_torch.viz import appearance as va
    from demiurge_tpu_torch.viz import projections as vp

    phase13_t0 = time.perf_counter()
    out13 = tempfile.TemporaryDirectory(dir=REPO, prefix=".phase13_")
    d13 = pathlib.Path(out13.name)
    rgrid = p12.grid
    rW, rH = rgrid.width, rgrid.height

    # the chain: every layer, the outlines and the dimming on the land
    # mask, the arrows on the session's currents
    def chain(p, land):
        return [va.ElevationMap(land="atlas", ocean="atlas"),
                va.Hillshade(multidirectional=True), va.SlopeMap(),
                va.AspectMap(), va.Graticules(),
                va.BrushOutline(center=(0.3, 0.7), size=40.0),
                va.SelectionOutline(sel=land, time=0.25),
                va.UnselectedDim(sel=land), va.VectorField(spacing=16)]

    LOBES = ((-180, -40, 180), (-100, 30), (-180, -100, -20, 80, 180),
             (-160, -60, 20, 140))
    globe = vp.orthographic_drag(
        vp.CanvasParams(projection="orthographic", window_aspect=2.0),
        rgrid, (0.45, 0.5), (0.6, 0.55))
    views = [(n, {}) for n in vp.PROJECTIONS] + [
        ("goode lobes", {"projection": "goode", "interruptions": LOBES}),
        ("globe after a drag", {"projection": "orthographic",
                                "ortho_state": globe.ortho_state})]

    def view_kw(name, kw):
        return {"projection": kw.get("projection", name),
                "window_aspect": 2.0,
                **{k: v for k, v in kw.items() if k != "projection"}}

    land_card = (p12.terrain > 0).float()
    layers_card = chain(p12, land_card)
    renders, render_ms, proj_ms = {}, {}, {}
    for name, kw in views:
        args = view_kw(name, kw)
        render_ms[name] = cuda_ms(lambda: p12.render(
            layers_card, out_w=rW, out_h=rH, **args), 3)
        renders[name] = p12.render(layers_card, out_w=rW, out_h=rH,
                                   **args).cpu()
    # the split: the chain alone, and each projection of its four channels
    rgba_dev = va.render(p12.terrain, rgrid, layers_card, uv=p12.ocean_uv)
    chain_ms = cuda_ms(lambda: va.render(p12.terrain, rgrid, layers_card,
                                         uv=p12.ocean_uv), 3)
    for name, kw in views:
        params = vp.CanvasParams(**view_kw(name, kw))
        proj_ms[name] = cuda_ms(lambda: vp.project_field(
            rgba_dev.permute(2, 0, 1), params, rgrid, rW, rH), 3)
    rgba_card = rgba_dev.cpu()
    del rgba_dev

    # the examples at their published defaults, in the background while
    # the rest of the phase runs on the host and the card
    ex_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    examples, ex_done = {}, {}

    def run_example(name):
        """Start the example, wait for it and keep (exit code, output,
        seconds to its own exit)."""
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", f"demiurge_tpu_torch.examples.{name}",
             "--out", str(d13 / f"{name}.png")], cwd=REPO, env=ex_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        ex_done[name] = (proc.returncode, text, time.perf_counter() - t0)

    for name in ("make_planet", "ocean_climate"):
        examples[name] = threading.Thread(target=run_example, args=(name,))
        examples[name].start()

    # each render against the same render of the same session on the CPU:
    # a pixel may differ where its source lies at a texel edge (the card's
    # libm and the host's round an ulp apart), on the projection's rim, or
    # on a texel the chain itself renders apart (a layer's threshold)
    p_cpu = Project(rW, rH, device="cpu")
    p_cpu.terrain = p12.terrain.cpu()
    p_cpu.ocean_uv = tuple(x.cpu() for x in p12.ocean_uv)
    land_cpu = (p_cpu.terrain > 0).float()
    layers_cpu = chain(p_cpu, land_cpu)
    rgba_cpu = va.render(p_cpu.terrain, rgrid, layers_cpu,
                         uv=p_cpu.ocean_uv)
    chain_off = (rgba_card - rgba_cpu).abs().amax(-1) > 1e-5
    chain_share = float(chain_off.float().mean())
    print(f"render at {rW}x{rH} ({card}): the chain of {len(layers_card)} "
          f"layers {chain_ms:.3f} ms (CUDA events, 3 calls); on the card "
          f"against the host: {int(chain_off.sum())} "
          f"texels beyond 1e-5 (share {chain_share:.2e}, bound 1e-3), max "
          f"{max_err(rgba_card, rgba_cpu):.3e}")
    assert chain_share <= 1e-3

    def near_edge(x, n, tol):
        xn = x.double() * n
        return (xn - torch.round(xn)).abs() <= n * tol

    def on_rim(oob):
        p = torch.nn.functional.pad(oob[None, None].float(), (1, 1, 1, 1),
                                    mode="replicate")[0, 0].bool()
        return ((p[1:-1, :-2] != oob) | (p[1:-1, 2:] != oob)
                | (p[:-2, 1:-1] != oob) | (p[2:, 1:-1] != oob))

    for name, kw in views:
        args = view_kw(name, kw)
        got = renders[name]
        want = p_cpu.render(layers_cpu, out_w=rW, out_h=rH, **args)
        assert got.shape == (rH, rW, 4) and bool(torch.isfinite(got).all())
        params = vp.CanvasParams(**args)
        sc, tc, oc = (x.cpu() for x in vp.screen_to_tex(params, rgrid, rW,
                                                        rH, dev))
        sh, th, oh = vp.screen_to_tex(params, rgrid, rW, rH, "cpu")
        valid = ~oc & ~oh
        tol = max(float((sc - sh).abs()[valid].max()),
                  float((tc - th).abs()[valid].max()), 2.0 ** -23)
        off = (got - want).abs().amax(-1) > 1e-5
        col = torch.clamp(torch.floor(sh * rW).long(), 0, rW - 1)
        row = torch.clamp(torch.floor(th * rH).long(), 0, rH - 1)
        edge = near_edge(sh, rW, tol) | near_edge(th, rH, tol)
        rim = on_rim(oh) & (oc != oh)
        at_chain = chain_off[row, col]
        unexplained = off & ~(edge | rim | at_chain)
        print(f"  {name:22s} {render_ms[name]:8.3f} ms, the projection "
              f"{proj_ms[name]:.3f} (CUDA events, 3 calls); against the "
              f"host: {int(off.sum())} pixels beyond "
              f"1e-5 (at texel edges {int((off & edge).sum())}, rim "
              f"{int((off & rim).sum())}, chain {int((off & at_chain).sum())},"
              f" unexplained {int(unexplained.sum())}), max "
              f"{max_err(got, want):.3e}; |ds|,|dt| <= {tol:.2e}")
        assert not bool(unexplained.any()), name
    del renders, rgba_card, rgba_cpu, p_cpu, layers_cpu, layers_card

    # the coupled CLI at W x H: 3 steps with --png; 2 steps with a
    # checkpoint every 2, resumed to 3; each save and load timed
    io_ms = {"save": [], "load": []}

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            io_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    zero_counts()
    png13 = d13 / "coupled.png"
    ck13 = str(d13 / "coupled.ckpt.npz")
    dims = ["--width", str(W), "--height", str(H)]
    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(io.StringIO()), \
            mock.patch.object(ckpt, "save", timed(ckpt.save, "save")), \
            mock.patch.object(ckpt, "load", timed(ckpt.load, "load")):
        straight = cli.main(["coupled", *dims, "--steps", "3", "--png",
                             str(png13)])
        cli.main(["coupled", *dims, "--steps", "2", "--checkpoint", ck13,
                  "--checkpoint-every", "2"])
        resumed = cli.main(["coupled", *dims, "--steps", "3", "--checkpoint",
                            ck13, "--checkpoint-every", "2", "--resume"])
    torch.cuda.synchronize()
    ckpt_forms = own_forms(read_counts(list(counters)))
    for name in single_card:
        assert ckpt_forms[name] > 0, f"{name} never launched in phase 13"
    assert read_png(png13).shape == (H, W, 4)
    assert ckpt.load(ck13, CoupledState, dev)[1] == 3
    ck_mb = pathlib.Path(ck13).stat().st_size / 1e6
    resume_err = {}
    for f in dataclasses.fields(CoupledState):
        a, b = getattr(resumed, f.name), getattr(straight, f.name)
        resume_err[f.name] = "bit for bit" if torch.equal(a, b) else \
            f"{max_err(a, b):.3e}"
        assert bool(torch.isfinite(a).all()), f.name
    for name in ("u", "v", "temperature"):
        a, b = getattr(resumed, name), getattr(straight, name)
        assert max_err(a, b) <= 1e-5 * float(b.abs().max()), name
    dh = (resumed.height - straight.height).abs() / straight.height.abs().max()
    assert float((dh > 1e-5).float().mean()) <= 1e-3
    print(f"coupled CLI at {W}x{H}: 3 steps with --png, and 2 steps with "
          f"--checkpoint-every 2 resumed to 3; resumed against "
          f"uninterrupted: {json.dumps(resume_err)}; checkpoint {ck_mb:.1f} "
          f"MB; saves {', '.join(f'{t:.1f}' for t in io_ms['save'])} ms, "
          f"load {', '.join(f'{t:.1f}' for t in io_ms['load'])} ms (host "
          f"clock, {card}); launches "
          f"{json.dumps({k: v for k, v in ckpt_forms.items() if v})}")

    # the 1x1 mesh: the CLI with a checkpoint, resumed; save_sharded and
    # load_sharded round trip on the NCCL mesh
    zero_counts()
    ckm = str(d13 / "mesh.ckpt.npz")
    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main(["coupled", "--mesh", "1x1", *dims, "--steps", "2",
                  "--checkpoint", ckm])
        m_resumed = cli.main(["coupled", "--mesh", "1x1", *dims, "--steps",
                              "3", "--checkpoint", ckm, "--resume"])
    torch.cuda.synchronize()
    mesh13_forms = own_forms(read_counts(list(counters)))
    for name in ("flow_local_solve", "flow_local_vis", "blur_strip",
                 "flow_directions_strip"):
        assert mesh13_forms[name] > 0, f"{name} never launched on the mesh"
    hold_to_single(m_resumed, straight,
                   "mesh CLI resumed to 3 against 3 single-card CLI steps")
    mdev = dmesh.initialize(DEVICE)
    mesh = dmesh.make_mesh(shape=(1, 1), device=mdev)
    sdir = str(d13 / "sharded")
    t0 = time.perf_counter()
    ckpt.save_sharded(sdir, m_resumed, 3, rgrid, mesh=mesh)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, step13 = ckpt.load_sharded(sdir, CoupledState, mesh=mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert step13 == 3
    for f in dataclasses.fields(CoupledState):
        assert torch.equal(getattr(back, f.name), getattr(m_resumed, f.name))
    backend13 = tdist.get_backend()
    tdist.destroy_process_group()
    print(f"  mesh 1x1 ({backend13}): CLI 2 steps + "
          f"checkpoint, resumed to 3, within the mesh bounds of the "
          f"single-card run; save_sharded {save_s * 1e3:.1f} ms, "
          f"load_sharded {load_s * 1e3:.1f} ms, bit for bit; launches "
          f"{json.dumps({k: v for k, v in mesh13_forms.items() if v})}")
    del straight, resumed, m_resumed, back

    # the examples: exit 0, a PNG of 2W x W each; each timed to its own
    # exit (they ran beside the rest of the phase)
    for name, thread in examples.items():
        thread.join()
        assert name in ex_done, f"example {name} did not finish"
        rc, text, took = ex_done[name]
        assert rc == 0, (name, text[-3000:])
        shape = read_png(d13 / f"{name}.png").shape
        want_shape = {"make_planet": (512, 1024, 4),
                      "ocean_climate": (360, 720, 4)}[name]
        assert shape == want_shape, (name, shape)
        print(f"  example {name} (published defaults): exit 0 in {took:.1f} "
              f"s with start-up, beside the phase; PNG {shape[1]}x{shape[0]}; "
              + "; ".join(l.strip() for l in text.splitlines()
                          if "max current" in l or "mean T" in l))
    print(f"phase 13 took {time.perf_counter() - phase13_t0:.1f} s")
    del p12
    out13.cleanup()
    torch.cuda.empty_cache()

    # -- 11. results ---------------------------------------------------------
    # each form's own launches on the path that runs it: the single-card
    # coupled CLI (phase 6; the sampler form is on no path and counts 0
    # there), the ocean CLI's one-row table (phase 4), the mesh step's
    # codes form and K10 (phase 8), K11's tools (phase 9), and K5 and K6's
    # codes form on the erosion and tectonic-erosion CLIs too (phases 10
    # and 10b)
    mesh_forms = own_forms(mesh_launches)
    main_launches = {**coupled_forms,
                     **{n: mesh_forms[n] for n in ("flow_directions",
                                                   "flow_local_solve",
                                                   "flow_local_vis",
                                                   "blur_strip",
                                                   "flow_directions_strip")},
                     **{n: ocean_forms[n] for n in ("advect_sample_pallas",
                                                    "advect_stage_one_row")},
                     **k11_launches}
    for n in ("blur", "flow_directions", "lake_relax", *lake_tiles):
        main_launches[n] += erosion_forms[n] + tecto_forms[n]
    for n in ("climate", "jacobi_pressure", "jacobi_diffusion",
              "advect_stage", "ocean_project", "blur", "flow_directions",
              "lake_relax", *lake_tiles):
        main_launches[n] += session_forms[n]
    for forms in (ckpt_forms, mesh13_forms, mesh8c_forms):
        for n, v in forms.items():
            main_launches[n] += v
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

"""Race the flow solvers on an evolved state and check each against K7/K8.

    python -m demiurge_tpu_torch.tools.flow_tune [W H] [--device D]
    python -m demiurge_tpu_torch.tools.flow_tune [W H] --kernel 2d|wave|banded

Defaults 2048 1024, on ``cuda``.  Evolves the reference tool's terrain
(fBm, 6 octaves, seed 7) by 10 ``coupled_step``s at ``CoupledConfig()``
(longer rivers than the initial noise), makes the flow masks of the result
and solves the (A, vis) fixpoint with: the production pair (K7's A and
K8's vis), the 2-D tiles (K11a: the TMA design, and the earlier one
launch a sweep), the one-launch fused solve in mode "both" and split into
"A" then "vis" (K11b), the delta wave (K11c: blocked in time on tiles,
and the earlier one launch a sweep) and the banded rounds (K11d: windows
in thread-block clusters, one launch a round, and the earlier one launch
a sweep).  Each is
checked on its first call, then timed over ``REPS`` more, with CUDA
events on the card (the host clock on the CPU), and prints ``ok`` only
when its A equals K7's bit for bit (the wave's, which adds in another
order, within rtol 1e-5, atol 1e-7) and its vis equals K8's.  On the CPU
every row runs the twins.  Nothing is caught: a mismatch exits 1, a
failure raises.

``--kernel 2d`` races the TMA design's sweeps a visit (4, 8, 16),
``--kernel wave`` the wave's sweeps a round (4, 8, 16), ``--kernel
banded`` the cluster windows' sweeps a round (4, 8, 16), band 64: a row
each, bit for bit against the default, K7+K8 (and for ``banded`` the
earlier one launch a sweep, k 16) timed first and last.  Card only.

``run`` is the tool less its argument parsing; ``chip_smoke.py`` calls it
with ``twins=True``, which also holds each solver to its plain twin.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.grid import Grid
from ..core.platform import use_cuda_kernels
from ..kernels import flow as kf
from ..kernels import flow_deadends as kd
from ..model import CoupledConfig, coupled_step, init_coupled
from . import flow_inputs, terrain

REPS = 3  # timed calls of each solver, after the one that is checked

COUNTERS = ((kf, "LAUNCHES_A", "flow_solve"), (kf, "LAUNCHES_VIS", "flow_vis"),
            (kd, "LAUNCHES_2D_TMA", "flow_solve_2d_tma"),
            (kd, "LAUNCHES_2D", "flow_solve_2d"),
            (kd, "LAUNCHES_FUSED", "flow_solve_fused"),
            (kd, "LAUNCHES_WAVE_TILES", "flow_solve_wave_tiles"),
            (kd, "LAUNCHES_WAVE", "flow_solve_wave"),
            (kd, "LAUNCHES_BANDED", "flow_banded_rounds"),
            (kd, "LAUNCHES_BANDED_SWEEPS", "flow_banded_sweeps"))


def _timed(fn, on_card: bool, reps: int = 1):
    """(fn()'s last result, ms a call over ``reps`` calls): CUDA events on
    the card, the host clock on the CPU."""
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def evolved_inputs(grid: Grid, device):
    """(packed masks, cell area) after 10 ``coupled_step``s at
    ``CoupledConfig()`` from the tools' terrain."""
    cfg = CoupledConfig()
    state = init_coupled(terrain(grid, device), grid)
    for _ in range(10):
        state = coupled_step(state, grid, cfg)
    return flow_inputs(state.height, grid)


def solvers(packed, area, grid: Grid):
    """[(label, kernel, solve, twin, exact)]: each solver as a call that
    returns (A, vis, stats).  ``kernel`` names its launch counter (None for
    the production pair), ``twin`` is the same solve on the plain twins
    (None for the production pair, whose twins phase 5 of the smoke
    checks), and ``exact`` says whether A must equal K7's bit for bit."""
    H, W = grid.shape
    band = 64 if H % 64 == 0 else kd.pick_band(H)
    on_card = use_cuda_kernels(area)
    tiles_take = kd.wave_tiles_take(grid)
    cluster_plan = kd.plan_banded(H, W, band, kd.BANDED_K) is not None

    def call(fn, *args):
        return lambda: fn(packed, area, grid, *args)

    def earlier(cuda, plain, *args):  # an earlier design: its twin on the
        return call(cuda if on_card else plain, *args)  # CPU

    def split(fused):
        def solve():
            A, _, sa = fused(packed, area, grid, mode="A")
            _, vis, sv = fused(packed, area, grid, mode="vis")
            return A, vis, {"A": sa, "vis": sv}
        return solve

    def production():
        return kf.flow_solve_area(packed, area, grid), \
            kf.vis_solve(packed, grid), dict(kf.LAST_SOLVE)

    return [
        ("K7+K8 (production)", None, production, None, True),
        (f"K11a TMA tiles k={kd.TMA_K}", "flow_solve_2d_tma",
         call(kd.flow_solve_2d), call(kd.flow_solve_2d_plain), True),
        ("K11a earlier: a launch a sweep, k=16", "flow_solve_2d",
         earlier(kd.flow_solve_2d_cuda, kd.flow_solve_2d_plain),
         call(kd.flow_solve_2d_plain), True),
        (f"K11b fused both k=16 band={kd.pick_band(H)}", "flow_solve_fused",
         call(kd.flow_solve_fused), call(kd.flow_solve_fused_plain), True),
        ("K11b fused split (A, then vis)", "flow_solve_fused",
         split(kd.flow_solve_fused), split(kd.flow_solve_fused_plain), True),
        # (the public entry runs the earlier design where the tiles do not
        # take the grid)
        (f"K11c wave tiles k={kd.WAVE_K}" if tiles_take else
         "K11c (W not for the tiles): a launch a sweep",
         "flow_solve_wave_tiles" if tiles_take else "flow_solve_wave",
         call(kd.flow_solve_wave), call(kd.flow_solve_wave_plain), False),
        ("K11c earlier: a launch a sweep", "flow_solve_wave",
         earlier(kd.flow_solve_wave_cuda, kd.flow_solve_wave_plain),
         call(kd.flow_solve_wave_plain), False),
        # (the public entry runs the earlier design where no cluster plan
        # fits)
        (f"K11d cluster rounds band={band} k={kd.BANDED_K}" if cluster_plan
         else f"K11d (no cluster plan): a launch a sweep, k={kd.BANDED_K}",
         "flow_banded_rounds" if cluster_plan else "flow_banded_sweeps",
         call(kd.flow_solve_banded_rounds, band, kd.BANDED_K),
         call(kd.flow_solve_banded_rounds_plain, band, kd.BANDED_K), True),
        ("K11d earlier: a launch a sweep, k=16",
         "flow_banded_sweeps",
         earlier(kd.flow_solve_banded_sweeps_cuda,
                 kd.flow_solve_banded_rounds_plain, band, 16),
         call(kd.flow_solve_banded_rounds_plain, band, 16), True),
    ]


def agrees(A, vis, A7, vis8, exact: bool) -> bool:
    """A equal to K7's (bit for bit, else within rtol 1e-5, atol 1e-7) and
    vis equal to K8's."""
    if exact:
        same_A = torch.equal(A, A7)
    else:
        same_A = bool(torch.allclose(A, A7, rtol=1e-5, atol=1e-7))
    return same_A and torch.equal(vis, vis8)


def race(packed, area, grid: Grid, twins: bool = False):
    """Solve with each solver, hold it to K7/K8 (with ``twins``, to its
    plain twin bit for bit as well), time it and print a line.  Returns the
    rows ({label, kernel, ms, twin_ms, differ, stats}) and whether every
    solver agreed."""
    on_card = use_cuda_kernels(area)
    A7 = kf.flow_solve_area(packed, area, grid)
    vis8 = kf.vis_solve(packed, grid)
    rows, all_ok = [], True
    for label, kernel, solve, twin, exact in solvers(packed, area, grid):
        A, vis, stats = solve()
        ok = agrees(A, vis, A7, vis8, exact)
        row = {"label": label, "kernel": kernel, "twin_ms": None,
               "differ": int((A != A7).sum()),
               "stats": {k: v for k, v in stats.items() if k != "active"}}
        note = ""
        if twins and twin is not None:
            (tA, tvis, _), row["twin_ms"] = _timed(twin, on_card)
            same = torch.equal(A, tA) and torch.equal(vis, tvis)
            ok = ok and same
            note = (f"; twin {row['twin_ms']:.3f} ms, "
                    f"{'bit-exact' if same else 'DIFFERS'}")
            del tA, tvis
        _, row["ms"] = _timed(solve, on_card, REPS)
        print(f"{label:40s} {row['ms']:10.3f} ms  "
              f"{'ok' if ok else 'MISMATCH'}  A cells differing from K7 "
              f"{row['differ']}; {row['stats']}{note}", flush=True)
        rows.append(row)
        all_ok = all_ok and ok
    return rows, all_ok


RACE_BAND = 64  # ``--kernel banded``'s band (the reference tool's)


def variants(kernel: str):
    """[(label, keyword arguments)] of ``--kernel``'s race, the default
    first."""
    name, first = {"2d": ("K11a", kd.TMA_K), "wave": ("K11c", kd.WAVE_K),
                   "banded": ("K11d", kd.BANDED_K)}[kernel]
    return [(f"{name} k={k}", {"k": k})
            for k in [first] + [k for k in (4, 8, 16) if k != first]]


def race_variants(packed, area, grid: Grid, kernel: str):
    """Each of ``variants(kernel)``, held bit for bit to the default's A
    and vis and timed (``REPS`` calls, CUDA events), between two timings
    of K7+K8 (and, for ``banded``, of the earlier design).  Returns the
    rows ({label, ms, stats}) and the yardsticks' times."""
    def banded(packed, area, grid, **kw):
        return kd.flow_solve_banded_rounds_cuda(packed, area, grid,
                                                RACE_BAND, **kw)

    solve = {"2d": kd.flow_solve_2d_tma_cuda,
             "wave": kd.flow_solve_wave_tiles_cuda, "banded": banded}[kernel]

    def production():
        return kf.flow_solve_area(packed, area, grid), \
            kf.vis_solve(packed, grid)

    def sweeps():
        return kd.flow_solve_banded_sweeps_cuda(packed, area, grid,
                                                RACE_BAND, 16)

    yards = {"K7+K8": production}
    if kernel == "banded":
        yards["K11d earlier: a launch a sweep, k=16"] = sweeps
    times = {}
    for label, fn in yards.items():
        times[label] = [_timed(fn, True, REPS)[1]]
        print(f"{label:40s} {times[label][0]:10.3f} ms", flush=True)
    rows, want = [], None
    for label, kw in variants(kernel):
        A, vis, stats = solve(packed, area, grid, **kw)
        if want is None:
            want = (A, vis)
        ok = torch.equal(A, want[0]) and torch.equal(vis, want[1])
        _, ms = _timed(lambda: solve(packed, area, grid, **kw), True, REPS)
        stats = {k: v for k, v in stats.items() if k != "active"}
        print(f"{label:40s} {ms:10.3f} ms  "
              f"{'bit-exact' if ok else 'DIFFERS'}  {stats}", flush=True)
        rows.append({"label": label, "ms": ms, "ok": ok, "stats": stats})
    for label, fn in reversed(yards.items()):
        times[label].append(_timed(fn, True, REPS)[1])
        print(f"{label:40s} {times[label][1]:10.3f} ms", flush=True)
    return rows, times


def run(W: int, H: int, device, twins: bool = False):
    """Evolve, race and print the launches of every counter, zeroed first.
    Returns (packed masks, rows, ok)."""
    grid = Grid(W, H)
    dev = torch.device(device)
    packed, area = evolved_inputs(grid, dev)
    on_card = use_cuda_kernels(area)
    clock = "CUDA events" if on_card else "host clock, cpu"
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"
    for mod, attr, _ in COUNTERS:
        setattr(mod, attr, 0)
    print(f"flow_tune {W}x{H} after 10 coupled steps on {where}; ms per "
          f"solve, {REPS} reps ({clock})", flush=True)
    rows, ok = race(packed, area, grid, twins)
    print(json.dumps({"kernel_launches": {
        name: getattr(mod, attr) for mod, attr, name in COUNTERS}}))
    return packed, rows, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("size", nargs="*", type=int, metavar="W H")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernel", choices=("2d", "wave", "banded"))
    args = p.parse_args(argv)
    if len(args.size) > 2:
        p.error("at most two numbers: W H")
    if args.kernel and args.device != "cuda":
        p.error("--kernel races the card's kernels: it needs --device cuda")
    W, H = list(args.size) + [2048, 1024][len(args.size):]
    if args.kernel:
        grid = Grid(W, H)
        packed, area = evolved_inputs(grid, torch.device("cuda"))
        print(f"flow_tune --kernel {args.kernel} {W}x{H} after 10 coupled "
              f"steps on {torch.cuda.get_device_name()}; ms per solve, "
              f"{REPS} reps (CUDA events)", flush=True)
        rows, _ = race_variants(packed, area, grid, args.kernel)
        return 0 if all(r["ok"] for r in rows) else 1
    return 0 if run(W, H, args.device)[2] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Race the flow solvers on an evolved state and check each against K7/K8.

    python -m demiurge_tpu_torch.tools.flow_tune [W H] [--device D]

Defaults 2048 1024, on ``cuda``.  Evolves the reference tool's terrain
(fBm, 6 octaves, seed 7) by 10 ``coupled_step``s at ``CoupledConfig()``
(longer rivers than the initial noise), makes the flow masks of the result
and solves the (A, vis) fixpoint with: the production pair (K7's A and
K8's vis), the 2-D tiles (K11a), the one-launch fused solve in mode
"both" and split into "A" then "vis" (K11b), the delta wave (K11c) and
the banded rounds (K11d).  Each is checked on its first call, then timed
over ``REPS`` more, with CUDA events on the card (the host clock on the
CPU), and prints ``ok`` only when its A equals K7's bit for bit (the
wave's, which adds in another order, within rtol 1e-5, atol 1e-7) and its
vis equals K8's.  Nothing is caught: a mismatch exits 1, a failure raises.

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
            (kd, "LAUNCHES_2D", "flow_solve_2d"),
            (kd, "LAUNCHES_FUSED", "flow_solve_fused"),
            (kd, "LAUNCHES_WAVE", "flow_solve_wave"),
            (kd, "LAUNCHES_BANDED", "flow_banded_rounds"))


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
    H = grid.height
    band = 64 if H % 64 == 0 else kd.pick_band(H)

    def call(fn, *args):
        return lambda: fn(packed, area, grid, *args)

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
        ("K11a 2-D tiles k=16", "flow_solve_2d", call(kd.flow_solve_2d),
         call(kd.flow_solve_2d_plain), True),
        (f"K11b fused both k=16 band={kd.pick_band(H)}", "flow_solve_fused",
         call(kd.flow_solve_fused), call(kd.flow_solve_fused_plain), True),
        ("K11b fused split (A, then vis)", "flow_solve_fused",
         split(kd.flow_solve_fused), split(kd.flow_solve_fused_plain), True),
        ("K11c wave", "flow_solve_wave", call(kd.flow_solve_wave),
         call(kd.flow_solve_wave_plain), False),
        (f"K11d banded rounds band={band} k=16", "flow_banded_rounds",
         call(kd.flow_solve_banded_rounds, band, 16),
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
    args = p.parse_args(argv)
    if len(args.size) > 2:
        p.error("at most two numbers: W H")
    W, H = list(args.size) + [2048, 1024][len(args.size):]
    return 0 if run(W, H, args.device)[2] else 1


if __name__ == "__main__":
    raise SystemExit(main())

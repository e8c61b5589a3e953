"""One run of one cell: set-up, the measured window, the comparison.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the grid, the settings, the run length, the
  check's tolerances and limits;
- ``entries/<config>.py``: ``Entry(cfg, terrain)`` with ``start()``,
  ``step(state)``, ``fields(state)``, ``stages`` (a step's work, for the
  rooflines) and ``spans`` (the program's functions the traced run wraps);
- ``reference/<config>.py``: ``init(cfg, terrain)`` and ``step(cfg,
  fields, terrain, index)``, the plain reference;
- ``traffic/<traffic>.json``: read by ``traffic.py``;
- ``metrics/<metric>.py``: ``read(trace)``, a value or None.

The window runs whole runs of the traffic's length back to back (closed
loop, one client), each from a fresh start on the seeded terrain, each
step ended by ``torch.cuda.synchronize()``, until ``seconds`` have passed.
A step's time runs from the end of the step before it, so a run's start
counts in its first step.  The fields of each run's first step and of
``later_steps`` steps drawn from the seed (with the steps before them) are
copied into buffers made once, so every run and every seed holds the same
memory, which the reported peak leaves out.  Once the window has closed
and the peak has been read, the reference follows the last run's kept
steps from their inputs: the first from its own start on the terrain, the
others from the program's fields of the step before.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import pathlib
import random
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules that may not be loaded in a run, by whole top-level name
FORBIDDEN = {"jax", "jaxlib", "flax", "demiurge_tpu"}


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def load_spec(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """A cell's files, found by the names in the spec."""

    def __init__(self, spec: dict, workload: str, bench: pathlib.Path = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        name = self.workload["config"]
        with open(bench / "configs" / f"{name}.json") as f:
            self.cfg = json.load(f)
        with open(bench / "traffic" / f"{self.workload['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.entry_path = bench / "entries" / f"{name}.py"
        self.reference = load_module(bench / "reference" / f"{name}.py",
                                     f"h100bench.reference.{_ident(name)}")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = {
            m["name"]: (m["unit"], load_module(
                bench / "metrics" / f"{m['name']}.py",
                f"h100bench.metrics.{_ident(m['name'])}"))
            for m in spec["per_layer"]
            if workload in m.get("workloads", [workload])}

    def entry_module(self):
        return load_module(self.entry_path,
                           f"h100bench.entries.{_ident(self.workload['config'])}")


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def _spans(entry, on: bool):
    """Wrap (or unwrap) the entry's program functions in profiler ranges
    of their own name, for the traced run only."""
    import torch

    for modname, fname in entry.spans:
        mod = sys.modules[modname]
        fn = getattr(mod, fname)
        if on and not hasattr(fn, "_h100bench_inner"):
            def wrapped(*a, _fn=fn, _name=fname, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)
            wrapped._h100bench_inner = fn
            setattr(mod, fname, wrapped)
        elif not on and hasattr(fn, "_h100bench_inner"):
            setattr(mod, fname, fn._h100bench_inner)


@contextlib.contextmanager
def _no_span(name):
    yield


def later_steps(seed: int, run_steps: int, k: int) -> list:
    """The compared steps after the first, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(2, run_steps + 1),
                                             min(k, run_steps - 1)))


def reference_pairs(ref, cfg: dict, terrain, kept: dict, later, sync):
    """(program fields, reference fields) of each compared step: the first
    from the reference's own start, the others from ``kept``'s fields of
    the step before."""
    pairs = []
    for j in [1] + list(later):
        src = ref.init(cfg, terrain) if j == 1 else kept[j - 1]
        pairs.append((kept[j], ref.step(cfg, src, terrain, j)))
        sync()
    return pairs


def quantile(values, q: float) -> float:
    """The q-quantile by Python's ``statistics.quantiles`` (inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        int(round(q * 100)) - 1]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, break_step=None) -> dict:
    """One run; returns the result line's object.  ``break_step``, for the
    harness's own tests, wraps the program's step (a planted fault)."""
    import torch

    from h100bench import compare, terrain as terrain_mod, traffic, work
    from h100bench import trace as trace_mod

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, plan = cell.cfg, traffic.plan(cell.traffic, cell.cfg)
    entry_mod = cell.entry_module()
    marks = [("imports", time.perf_counter())]
    if on_card:
        from demiurge_tpu_torch.kernels import build
        build.build()
        build.library()
    marks.append(("kernels", time.perf_counter()))

    terrain = terrain_mod.fbm(cfg["width"], cfg["height"], cfg["terrain"],
                              seed, device)
    sync()
    marks.append(("terrain", time.perf_counter()))
    entry = entry_mod.Entry(cfg, terrain)
    step = entry.step if break_step is None else break_step(entry.step)
    later = later_steps(seed, plan.run_steps, cfg["check"]["later_steps"])
    keep = {1} | set(later) | {j - 1 for j in later}

    bufs: dict = {}     # the kept fields, copied: the same memory each run
    # the benchmark's own spans around each run's start and each step
    span = torch.profiler.record_function if trace else _no_span

    def one_run(times=None, t_prev=None):
        with span("start"):
            state = entry.start()
        for i in range(1, plan.run_steps + 1):
            with span("step"):
                state = step(state)
            if i in keep:
                fields = entry.fields(state)
                if i not in bufs:
                    bufs[i] = {k: torch.empty_like(x)
                               for k, x in fields.items()}
                for k, x in fields.items():
                    bufs[i][k].copy_(x)
            sync()
            if times is not None:
                t = time.perf_counter()
                times.append(t - t_prev)
                t_prev = t
        return t_prev

    one_run()          # every shape, the allocator and the buffers, warmed
    sync()
    if on_card:        # the window's runs do all of the set-up's device work
        torch.cuda.reset_peak_memory_stats()
    if trace:
        _spans(entry, True)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up run", t_start + setup_s))
    print("set-up: " + ", ".join(
        f"{n} {b - a:.3f} s" for (_, a), (n, b) in
        zip([("", t_start)] + marks[:-1], marks)), file=sys.stderr)

    times: list = []
    events: list = []
    runs = 0
    t0 = t_prev = time.perf_counter()
    while True:
        if trace and runs == 1:
            t_traced = t_prev
            with trace_mod.profiled() as events:
                with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
                    t_prev = one_run(times, t_prev)
            t_traced = t_prev - t_traced
        else:
            t_prev = one_run(times, t_prev)
        runs += 1
        if t_prev - t0 >= seconds and (runs >= 2 or not trace):
            break
    window_s = t_prev - t0
    if trace:
        _spans(entry, False)
    kept_bytes = sum(x.numel() * x.element_size()
                     for f in bufs.values() for x in f.values())
    # the program's own peak: the kept copies are the harness's
    peak = torch.cuda.max_memory_allocated() - kept_bytes if on_card else 0
    del entry, step

    # the comparison, after the window and the peak
    t_ref = time.perf_counter()
    pairs = reference_pairs(cell.reference, cfg, terrain, bufs, later, sync)
    print(f"reference: {len(pairs)} steps in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    compared, failed = compare.compare_steps(pairs, cfg["check"])
    correct = compare.passed(compared)

    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(times), "failed": failed}
    if not trace:
        values = {"step_ms": window_s / len(times) * 1e3,
                  "step_p95_ms": quantile(times, 0.95) * 1e3,
                  "peak_mem_gib": peak / 2 ** 30,
                  "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end if m["name"] in values}
    else:
        plain = len(times) - plan.run_steps     # the unprofiled steps
        tr = trace_mod.Trace(events, plan.run_steps, entry_mod.stages(cfg),
                             work.peaks_for(kind),
                             (window_s - t_traced) / plain if plain else None)
        out["metrics"] = {}
        for name, (unit, reader) in cell.per_layer.items():
            v = reader.read(tr)
            if v is not None and math.isfinite(v):
                out["metrics"][name] = {"value": v, "unit": unit}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["device"] = dev
    out["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


"""What a traced run's profile says: device activity, kernels by name,
the device time launched under each span, and the idle gaps.

The profile is ``torch.profiler``'s Chrome trace.  A device event (kernel,
copy or fill) is tied to the host call that launched it by its correlation
id; a span (a ``record_function`` range of the benchmark's own) holds the
device events whose launch call lies inside it.  All times are seconds.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW_SPAN = "h100bench.window"


class Trace:
    """``events``: the Chrome trace's events.  ``steps``: the steps run in
    the window span; ``stages``: a step's (stage, bytes, flops);
    ``peaks``: the card's (``work.PEAKS``), or None; ``step_s``: the wall
    time a step of the run's unprofiled steps, or None."""

    def __init__(self, events, steps: int, stages, peaks, step_s=None):
        self.steps, self.stages, self.peaks = steps, stages, peaks
        self.step_s = step_s
        launch = {}
        self.spans = []
        self.device = []   # (name, start, end, launched at)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
            if cat == "cuda_runtime" or cat == "cuda_driver":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = t0
            elif cat == "user_annotation":
                self.spans.append((e["name"], t0, t1))
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                t0 = float(e["ts"]) * 1e-6
                t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
                corr = e.get("args", {}).get("correlation")
                self.device.append((e["name"], t0, t1, launch.get(corr)))
        win = [s for s in self.spans if s[0] == WINDOW_SPAN]
        self.window = (win[0][1], win[0][2]) if win else None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def in_window(self):
        """The device events inside the window, clipped to it."""
        if self.window is None:
            return []
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1), at) for n, a, b, at in self.device
                if b > w0 and a < w1]

    def busy(self):
        """The union of the window's device intervals, merged, in order."""
        out = []
        for _, a, b, _ in sorted(self.in_window(), key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_time(self, match) -> float:
        """Summed device time of the window's events whose name ``match``
        accepts."""
        return sum(b - a for n, a, b, _ in self.in_window() if match(n))

    def time_under(self, span: str) -> float:
        """Device time of the window's events launched inside a span of
        that name."""
        ranges = [(a, b) for n, a, b in self.spans if n == span]
        return sum(b - a for _, a, b, at in self.in_window()
                   if at is not None and any(s <= at <= e for s, e in ranges))

    def host_at(self, t: float) -> str:
        """The innermost span of the benchmark's open on the host at t (a
        gap is named at its middle)."""
        inner = None
        for n, a, b in self.spans:
            if a <= t <= b and n != WINDOW_SPAN and (
                    inner is None or b - a < inner[1]):
                inner = (n, b - a)
        return inner[0] if inner else "host"

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10
        longest idle gaps by what the host was doing."""
        ops: dict = {}
        for n, a, b, _ in self.in_window():
            ops[n] = ops.get(n, 0.0) + (b - a)
        gaps = []
        busy = self.busy()
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]] if self.window else []
        for i in range(0, len(edges) - 1, 2):
            a, b = edges[i], edges[i + 1]
            if b > a:
                gaps.append((self.host_at((a + b) / 2), b - a))
        return {
            "device_ops": [[n[:64], s] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(
                gaps, key=lambda g: -g[1])[:10]]}


@contextlib.contextmanager
def profiled():
    """Profile the block on the host and the card; yields a list that
    holds the Chrome trace's events after the block.  The file goes under
    TMPDIR and is removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.extend(json.load(f)["traceEvents"])

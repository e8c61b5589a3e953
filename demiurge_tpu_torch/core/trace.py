"""Named spans of the program, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` profile is running: the span then lands in the same
trace as the device's kernels, copies and fills, on one clock, nested in
whatever span is open around it on the thread.  With no profiler running
it returns one shared context that does nothing (a flag check, no
allocation).  The profiler being on is the only switch.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context around the work it names: a profiler range while a
    profiler runs, otherwise nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF

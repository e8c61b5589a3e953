"""Progress reporting + cooperative cancellation for long operations.

The reference wraps every long filter in a ``ProgressFilter`` (modal
progress bar + Cancel button; src/filter/Filter.h:117-130): ``SubFilter::
step`` returns ``(finished, progress)`` each frame, and Cancel calls
``restoreBackup()`` (Filter.cpp:105-115).  Counterpart of ``demiurge_tpu/utils/progress.py``:

- long loops (``ops.erosion.landscape_evolution``,
  ``ops.erosion.coupled_tectonic_erosion``, ``ops.temperature.run_years``)
  accept a :class:`Progress` object and call ``progress(i, n, **metrics)``
  between device dispatches;
- ``Progress.cancel()`` (callable from the callback or another thread)
  makes the loop stop at the next dispatch boundary and return the
  last completed state — the ``api.Project`` layer records every
  operator in the undo history, so cancel-then-undo is the reference's
  cancel-restore.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Cancelled(Exception):
    """Raised by Progress.check() when aborted with raise_on_cancel."""


class Progress:
    """Progress sink with cooperative cancellation.

    ``callback(fraction, info)`` is invoked at most every
    ``min_interval`` seconds (plus always on the final step); ``info``
    carries the step counter and any metrics the loop reports.
    """

    def __init__(self, callback: Optional[Callable] = None,
                 min_interval: float = 0.0):
        self.callback = callback
        self.min_interval = min_interval
        self._cancelled = False
        self._last = 0.0
        self.fraction = 0.0

    def cancel(self):
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def __call__(self, i: int, n: int, **info) -> bool:
        """Report step i of n; returns True while the operation should
        continue (False once cancelled)."""
        self.fraction = (i + 1) / max(n, 1)
        now = time.monotonic()
        if self.callback is not None and (
                now - self._last >= self.min_interval or i + 1 == n):
            self._last = now
            self.callback(self.fraction, dict(step=i + 1, total=n, **info))
        return not self._cancelled

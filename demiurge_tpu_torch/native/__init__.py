"""Native (C++) host code of the port, bound by ctypes.

Counterpart of ``demiurge_tpu/native``: ``lake_solver.cpp`` is the port's
own copy of the flow routing's host stages (basin flood fill, saddle
search, lowest-pass merge, lake fill), ``snap_codec.cpp`` its copy of the
undo snapshots' codec (``snapc``); each is compiled with the host's
``g++`` at its first use (``build``) into ``demiurge_tpu_torch/_build/``.
"""

from .lakes import solve_lakes_native

__all__ = ["solve_lakes_native"]

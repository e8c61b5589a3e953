"""Blend modes and selection combination modes.

Counterpart of ``demiurge_tpu/ops/blend.py``: the reference's filter blend
modes (Filter.cpp:170-239; several ignore the selection weight, kept so)
and its selection combination modes (selection.cpp:52-116).
"""

from __future__ import annotations

import torch

BLEND_MODES = ("replace", "add", "subtract", "multiply", "divide", "max",
               "min")
SELECTION_MODES = ("replace", "add", "subtract", "intersect")


def blend(old, new, selection, mode: str = "replace"):
    """filter::blendMode (Filter.cpp:172-206)."""
    if mode == "replace":
        return old * (1 - selection) + new * selection
    if mode == "add":
        return old + selection * new
    if mode == "subtract":
        return torch.clamp(old - new, min=0)
    if mode == "multiply":
        return old * new
    if mode == "divide":
        return old / new
    if mode == "max":
        return torch.maximum(old, new)
    if mode == "min":
        return torch.minimum(old, new)
    raise ValueError(f"unknown blend mode {mode!r}")


def selection_mode(old, new, mode: str = "replace"):
    """selection::selection_mode (selection.cpp:52-77)."""
    if mode == "replace":
        return new
    if mode == "add":
        return torch.clamp(old + new, max=1)
    if mode == "subtract":
        return torch.clamp(old - new, min=0)
    if mode == "intersect":
        return old * new
    raise ValueError(f"unknown selection mode {mode!r}")

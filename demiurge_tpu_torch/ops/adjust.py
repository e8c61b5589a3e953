"""Instant height adjustments: offset and scale.

Counterpart of ``demiurge_tpu/ops/adjust.py`` (the reference's
OffsetMenu.cpp:21-37 and ScaleMenu.cpp:21-37): a selection-weighted
constant added, or a selection-weighted factor applied.
"""

from __future__ import annotations


def offset(height, sel, value: float):
    """height + value * sel."""
    return height + value * sel


def scale(height, sel, factor: float):
    """height * lerp(1, factor, sel)."""
    return height * (1.0 + (factor - 1.0) * sel)

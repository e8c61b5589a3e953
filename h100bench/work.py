"""The chip's peaks and the least time a piece of work can take on it.

A stage's bound is max(bytes / peak bandwidth, float32 operations / peak
float32 rate): the bytes of its inputs read once and of its outputs
written once, the operations that these inputs need, counted from the
grid and the sweep counts (``entries/<config>.py`` lists a step's stages).
The count is the same whatever implements the stage, so a share of it
bounds a gain after a later change takes a kernel off the path.
"""

from __future__ import annotations

#: NVIDIA's data sheet, not a measurement, by the exact name that
#: ``torch.cuda.get_device_name()`` gives: the H100 SXM at its 700 W
#: limit, its HBM3 bandwidth and dense float32 rate outside the tensor
#: cores.  Other H100 forms (PCIe, NVL) have lower peaks and are not here.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flops_per_s": 67e12}}


def peaks_for(kind: str):
    """The peaks of the card named ``kind``, or None for a card this table
    does not hold."""
    return PEAKS.get(kind)


def bound_s(bytes_: float, flops: float, peaks: dict) -> float:
    return max(bytes_ / peaks["bytes_per_s"],
               flops / peaks["f32_flops_per_s"])


def stages_bound_s(stages, peaks: dict, names=None) -> float:
    """The summed bound of the stages (name, bytes, flops) whose name is in
    ``names`` (all of them where None)."""
    return sum(bound_s(b, f, peaks) for n, b, f in stages
               if names is None or n in names)

"""The flow fixpoint (upstream area, mouth reachability; K7, K8) against
its bound: the bytes these inputs need (masks, area and warm start in, the
area out: 16 bytes a pixel; masks in, one byte out: 5) over the device
time of the kernels named ``area_tile`` and ``vis_tile``.  Nothing to read
where no such kernel ran."""

from h100bench.work import stages_bound_s

STAGES = ("flow_area", "flow_vis")


def read(t):
    busy = t.device_time(lambda n: "area_tile" in n or "vis_tile" in n)
    if not busy or t.peaks is None:
        return None
    return 100.0 * t.steps * stages_bound_s(t.stages, t.peaks, STAGES) / busy

"""The readers of the program's own spans (the stages of ``coupled_step``
and ``ocean_step``, the flow solves' host reads) on a hand-made trace, and
nothing read where the program has no such span."""

import pytest

from h100bench import harness, trace, work

H100 = work.PEAKS["NVIDIA H100 80GB HBM3"]

READERS = ("climate_ms", "erosion_ms", "ocean_coeffs_ms",
           "ocean_divergence_ms", "ocean_project_ms", "ocean_idle_ms",
           "flow_idle_ms", "flow_reads_per_step")


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _op(launched, start, dur, corr, name="k"):
    """A kernel and the launch call that sent it."""
    return [_ev("cuda_runtime", "cudaLaunchKernel", launched, 0.5, corr),
            _ev("kernel", name, start, dur, corr)]


# the program's spans of one coupled step (us), each with what it holds
SPANS = [
    ("coupled_step", 1, 98),
    ("climate", 2, 8),
    ("ocean", 11, 49),
    ("ocean.viscosity", 12, 8), ("ocean.viscosity.coefficients", 12, 2),
    ("ocean.divergence", 21, 2),
    ("ocean.pressure", 31, 19), ("ocean.pressure.coefficients", 31, 4),
    ("ocean.project", 51, 8),
    ("flow", 61, 29), ("flow.area", 62, 18), ("flow.read", 70, 5),
    ("flow.read", 86, 2),
    ("erosion", 91, 7),
]
OPS = [
    (3, 10, 10),     # climate: 10-20, busy from 10
    (13, 20, 5),     # the viscosity coefficients: 20-25
    (22, 26, 4),     # divergence after a 1 us gap (ocean)
    (34, 40, 5),     # pressure coefficients after 10 us idle (ocean)
    (52, 53, 7),     # projection after 8 us idle (ocean)
    (76, 77, 8),     # the area solve after its read: 17 us idle (flow)
    (92, 93, 4),     # the erosion pass after 8 us idle (neither)
]


def _trace(drop=()):
    """A window of 200 us that holds two steps' worth of spans: after the
    last operation (97 us) the card idles to the window's end."""
    events = [_span(trace.WINDOW_SPAN, 0, 200), _span("step", 0, 100),
              _span("ocean_step", 10.5, 50)]
    events += [_span(n, a, d) for n, a, d in SPANS if n not in drop]
    for i, (at, start, dur) in enumerate(OPS):
        events += _op(at, start, dur, i + 1)
    return trace.Trace(events, 2, [("pressure", 1, 1)], H100)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"h100bench.metrics.{name}")


def test_stage_readers_on_a_hand_made_trace():
    t = _trace()
    assert _reader("climate_ms").read(t) == pytest.approx(10e-3 / 2)
    assert _reader("ocean_coeffs_ms").read(t) == pytest.approx(10e-3 / 2)
    assert _reader("ocean_divergence_ms").read(t) == pytest.approx(4e-3 / 2)
    assert _reader("ocean_project_ms").read(t) == pytest.approx(7e-3 / 2)
    assert _reader("erosion_ms").read(t) == pytest.approx(4e-3 / 2)
    assert _reader("flow_reads_per_step").read(t) == 1.0


def test_a_gap_goes_to_the_span_that_launched_its_end():
    """The 10 us gap before the pressure coefficients' kernel counts for the
    ocean and not for the flow; the gap the flow's read leaves counts for
    the flow; the erosion's gap and the window's idle tail count for
    neither.  Moved under a read, the launch's gap goes to the flow."""
    t = _trace()
    assert _reader("ocean_idle_ms").read(t) == pytest.approx(
        (1 + 10 + 8) * 1e-3 / 2)
    assert _reader("flow_idle_ms").read(t) == pytest.approx(17e-3 / 2)
    moved = _trace()
    moved.spans = [(n, a, b) for n, a, b in moved.spans
                   if n != "ocean.pressure.coefficients"] + [
        ("flow.read", 33e-6, 35e-6)]
    assert _reader("ocean_idle_ms").read(moved) == pytest.approx(
        9e-3 / 2)
    assert _reader("flow_idle_ms").read(moved) == pytest.approx(27e-3 / 2)


def test_of_operations_starting_together_the_first_launched_ends_a_gap():
    events = [_span(trace.WINDOW_SPAN, 0, 100), _span("ocean", 1, 10),
              _span("flow", 20, 10)]
    events += _op(25, 40, 5, 1) + _op(5, 40, 3, 2)
    t = trace.Trace(events, 1, [], None)
    assert _reader("ocean_idle_ms").read(t) == pytest.approx(40e-3)
    assert _reader("flow_idle_ms").read(t) == 0.0


SPAN_OF = {
    "climate_ms": ("climate",), "erosion_ms": ("erosion",),
    "ocean_coeffs_ms": ("ocean.viscosity.coefficients",
                        "ocean.pressure.coefficients"),
    "ocean_divergence_ms": ("ocean.divergence",),
    "ocean_project_ms": ("ocean.project",),
    "ocean_idle_ms": tuple(n for n, _, _ in SPANS
                           if n.split(".")[0] == "ocean"),
    "flow_idle_ms": tuple(n for n, _, _ in SPANS
                          if n.split(".")[0] == "flow"),
    "flow_reads_per_step": ("flow.read",)}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_without_its_span(name):
    assert _reader(name).read(_trace()) is not None
    assert _reader(name).read(_trace(drop=SPAN_OF[name])) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_a_program_without_spans(name):
    """The parent's program: only the harness's own spans."""
    t = _trace(drop={n for n, _, _ in SPANS})
    assert t.time_under("ocean_step") > 0
    assert _reader(name).read(t) is None
    assert _reader(name).read(trace.Trace([], 2, [], None)) is None


@pytest.mark.parametrize("name", [n for n in READERS
                                  if n != "flow_reads_per_step"])
def test_readers_find_nothing_without_device_events(name):
    """A run on the CPU: the program's spans, no operation on a card.
    (``flow_reads_per_step`` counts host reads, which only a card's
    solves make.)"""
    t = _trace()
    t.device = []
    assert _reader(name).read(t) is None

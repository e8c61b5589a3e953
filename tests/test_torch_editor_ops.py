"""The port's editor ops against the reference, at 64x32: adjust, blend,
thermal, morphology, the selection tools, the brush and ``Progress``.

Tolerances, and why (the reference path named in each test):

- adjust, blend (every mode), selection_mode, by_height, invert,
  apply_selection: bit for bit (the same float32 operations).
- thermal erosion: bit for bit against the reference op by op and jitted.
- morphology (min and max, radii 1 to 8, the x-periodic and the regional
  path), grow, shrink, border: exactly equal (nearest taps, min and max).
- the selection blur: exactly equal against the reference op by op (the
  same taps as ``ops.blur``).
- lasso: the plane normals are Python floats in both; the pixel points
  come from each library's cos and sin, so a pixel on a triangle's edge
  may flip; flips counted, at most 1% of the pixels (0 in these paths).
- brush: ``brush_profile`` and ``stroke_rotation`` bit for bit (numpy in
  both); ``segment_accumulate`` bit for bit with XLA's sin, cos, asin,
  atan2 and sqrt swapped into the port (tests/torch_xla_libm.py), and
  within 1e-6 of the LUT's max without them (each contribution is the
  difference of two LUT fetches, whose coordinates come from atan2 and
  asin); a whole stroke the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demiurge_tpu_torch.core.grid as tgrid_module
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import adjust as ja
from demiurge_tpu.ops import blend as jbl
from demiurge_tpu.ops import brush as jb
from demiurge_tpu.ops import morphological as jm
from demiurge_tpu.ops import thermal as jt
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu.select import selection as js
from demiurge_tpu.utils import progress as jprog
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import adjust as ta
from demiurge_tpu_torch.ops import blend as tbl
from demiurge_tpu_torch.ops import brush as tb
from demiurge_tpu_torch.ops import morphological as tm
from demiurge_tpu_torch.ops import thermal as tt
from demiurge_tpu_torch.select import selection as ts
from demiurge_tpu_torch.utils import progress as tprog
from torch_xla_libm import xla_libm

torch.set_num_threads(2)

W, H = 64, 32
JG, TG = JGrid(W, H), TGrid(W, H)
REGIONAL = (-1.0, 0.5, -2.0, 1.5)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(3)
    h = np.asarray(fbm(JG, NoiseParams(octaves=4, scale=2.0, min=-2.0,
                                       max=3.0, seed=5)))
    h = (h + rng.normal(0, 0.3, h.shape)).astype(np.float32)
    sel = (rng.random((H, W)) > 0.5).astype(np.float32)
    soft = rng.random((H, W)).astype(np.float32)
    return h, sel, soft


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_adjust_bit_for_bit(fields):
    h, _, soft = fields
    _equal(ta.offset(_t(h), _t(soft), -0.7),
           ja.offset(jnp.asarray(h), jnp.asarray(soft), -0.7))
    _equal(ta.scale(_t(h), _t(soft), 1.3),
           ja.scale(jnp.asarray(h), jnp.asarray(soft), 1.3))


@pytest.mark.parametrize("mode", jbl.BLEND_MODES)
def test_blend_modes_bit_for_bit(fields, mode):
    h, _, soft = fields
    new = np.roll(h, 5, axis=1) + 0.1
    _equal(tbl.blend(_t(h), _t(new), _t(soft), mode),
           jbl.blend(jnp.asarray(h), jnp.asarray(new), jnp.asarray(soft),
                     mode))


@pytest.mark.parametrize("mode", jbl.SELECTION_MODES)
def test_selection_modes_bit_for_bit(fields, mode):
    _, sel, soft = fields
    _equal(ts.apply_selection(_t(soft), _t(sel), mode),
           js.apply_selection(jnp.asarray(soft), jnp.asarray(sel), mode))
    _equal(tbl.selection_mode(_t(sel), _t(soft), mode),
           jbl.selection_mode(jnp.asarray(sel), jnp.asarray(soft), mode))


def test_unknown_modes_raise(fields):
    h, _, soft = fields
    with pytest.raises(ValueError):
        tbl.blend(_t(h), _t(h), _t(soft), "overlay")
    with pytest.raises(ValueError):
        tbl.selection_mode(_t(soft), _t(soft), "xor")
    with pytest.raises(ValueError):
        tm.morphology(_t(h), TG, 2.0, "mean")


def test_by_height_and_invert_bit_for_bit(fields):
    h, _, soft = fields
    _equal(ts.by_height(_t(h), -0.5, 1.25),
           js.by_height(jnp.asarray(h), -0.5, 1.25))
    _equal(ts.invert(_t(soft)), js.invert(jnp.asarray(soft)))
    _equal(ts.select_all(TG, "cpu"), js.select_all(JG))
    _equal(ts.select_none(TG, "cpu"), js.select_none(JG))


@pytest.mark.parametrize("jit", [False, True])
def test_thermal_bit_for_bit(fields, jit):
    h, _, _ = fields
    if jit:
        want = jt.thermal_erosion_step(jnp.asarray(h), JG)
    else:
        with jax.disable_jit():
            want = jt.thermal_erosion_step(jnp.asarray(h), JG)
    _equal(tt.thermal_erosion_step(_t(h), TG), want)


def test_thermal_conservative_bit_for_bit(fields):
    h, _, _ = fields
    with jax.disable_jit():
        want = jt.thermal_erosion_step(jnp.asarray(h), JG, substeps=3,
                                       conservative=True)
    _equal(tt.thermal_erosion_step(_t(h), TG, substeps=3,
                                   conservative=True), want)


@pytest.mark.parametrize("radius", [0.5, 1.0, 2.5, 5.0, 8.0, 13.0])
def test_radius_list(radius):
    assert tm.radius_list(radius) == jm.radius_list(radius)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("radius", [2.5, 8.0])
def test_morphology_exact(fields, op, radius):
    """The x-periodic path: per-row column rolls from the same float32
    host taps (op by op; the taps are equal, so min and max are)."""
    h, _, _ = fields
    with jax.disable_jit():
        want = jm.morphology(jnp.asarray(h), JG, radius, op)
    _equal(tm.morphology(_t(h), TG, radius, op), want)


def test_morphology_regional_exact(fields):
    """The gather path of a grid that is not x-periodic."""
    h = fields[0][:24, :48]
    jg = JGrid(48, 24, coords=REGIONAL)
    tg = TGrid(48, 24, coords=REGIONAL)
    for op in ("min", "max"):
        with jax.disable_jit():
            want = jm.morphology(jnp.asarray(h), jg, 3.0, op)
        _equal(tm.morphology(_t(h), tg, 3.0, op), want)


@pytest.mark.parametrize("tool, radius", [("grow", 2.5), ("shrink", 1.0),
                                          ("border", 4.0)])
def test_selection_morphology_exact(fields, tool, radius):
    _, sel, _ = fields
    with jax.disable_jit():
        want = getattr(js, tool)(jnp.asarray(sel), JG, radius)
    _equal(getattr(ts, tool)(_t(sel), TG, radius), want)


def test_selection_blur_exact(fields):
    _, sel, _ = fields
    with jax.disable_jit():
        want = js.blur_selection(jnp.asarray(sel), JG, 2.0)
    _equal(ts.blur_selection(_t(sel), TG, 2.0), want)


LASSOS = [
    [(0.1, 0.2), (0.5, 0.3), (0.45, 0.8), (0.2, 0.7), (0.15, 0.4)],
    # across the dateline and near the north pole; a repeated point
    [(0.9, 0.5), (0.97, 0.8), (0.97, 0.8), (0.05, 0.93), (0.2, 0.6),
     (0.92, 0.3)],
    # too short: only the despeckle of an empty parity
    [(0.3, 0.3), (0.6, 0.6)],
]


@pytest.mark.parametrize("path", range(len(LASSOS)))
@pytest.mark.parametrize("mode", ["replace", "add", "intersect"])
def test_lasso_flips_bounded(fields, path, mode):
    """Pixels whose half-plane sign flips against the reference (op by
    op): counted, at most 1% of the pixels."""
    _, sel, _ = fields
    with jax.disable_jit():
        want = np.asarray(js.lasso(jnp.asarray(sel), JG, LASSOS[path], mode))
    got = ts.lasso(_t(sel), TG, LASSOS[path], mode).numpy()
    flips = int((got != want).sum())
    print(f"lasso {path} {mode}: {flips} of {H * W} pixels flipped")
    assert flips <= 0.01 * H * W
    assert set(np.unique(got)) <= {0.0, 1.0} or mode != "replace"


@pytest.mark.parametrize("hardness", [0.0, 0.3, 0.5, 0.9])
def test_brush_profile_bit_for_bit(hardness):
    np.testing.assert_array_equal(tb.brush_profile(hardness),
                                  jb.brush_profile(hardness))


@pytest.mark.parametrize("pos, prev", [((0.95, 0.9), (0.02, 0.95)),
                                       ((0.3, 0.4), (0.35, 0.45)),
                                       ((0.5, 0.05), (0.5, 0.02))])
def test_stroke_rotation_bit_for_bit(pos, prev):
    got = tb.stroke_rotation(TG, pos, prev)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jb.stroke_rotation(JG, pos, prev))


SEGMENTS = [((0.95, 0.9), (0.02, 0.95), 10.0, 0.7),
            ((0.3, 0.4), (0.35, 0.45), 6.5, 1.0),
            ((0.5, 0.05), (0.6, 0.02), 25.0, 0.3)]


def _segment(which, lut, sel, libm=False):
    pos, prev, size, flow = SEGMENTS[which]
    R = jb.stroke_rotation(JG, pos, prev)
    acc = np.zeros((H, W), np.float32)
    with jax.disable_jit():
        want = np.asarray(jb.segment_accumulate(
            jnp.asarray(acc), jnp.asarray(sel), jnp.asarray(lut),
            jnp.asarray(R), jnp.asarray(prev, jnp.float32), JG, size, flow))

    def port():
        return tb.segment_accumulate(_t(acc), _t(sel), _t(lut), _t(R),
                                     _t(prev), TG, size, flow).numpy()

    if libm:
        with xla_libm(tb, tgrid_module):
            return port(), want
    return port(), want


@pytest.mark.parametrize("which", range(len(SEGMENTS)))
def test_segment_accumulate(fields, which):
    _, _, soft = fields
    lut = jb.brush_profile(0.4)
    got, want = _segment(which, lut, soft)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * lut.max())
    got, want = _segment(which, lut, soft, libm=True)
    np.testing.assert_array_equal(got, want)


def test_brush_stroke_matches_reference(fields):
    """A whole stroke across the dateline near the north pole, through
    ``BrushStroke`` (op by op): the height and the diff within 1e-6 of
    the LUT's max times the stroke's segments."""
    h, _, soft = fields
    path = [(0.9, 0.55), (0.97, 0.7), (0.03, 0.85), (0.12, 0.93),
            (0.25, 0.9)]
    jparams = jb.BrushParams(size=6.0, value=0.8, hardness=0.3, limit=0.5)
    tparams = tb.BrushParams(**dataclasses.asdict(jparams))
    with jax.disable_jit():
        js_ = jb.BrushStroke(jnp.asarray(h), jnp.asarray(soft), JG, jparams)
        for prev, pos in zip(path[:-1], path[1:]):
            js_.segment(pos, prev)
        jh, jd = js_.finish()
    ts_ = tb.BrushStroke(_t(h), _t(soft), TG, tparams)
    for prev, pos in zip(path[:-1], path[1:]):
        ts_.segment(pos, prev)
    th, td = ts_.finish()
    tol = 1e-6 * tb.brush_profile(0.3).max() * (len(path) - 1)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=tol)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=tol)
    assert float(td.abs().max()) > 0


def test_progress_matches_reference():
    seen = {"j": [], "t": []}
    jp = jprog.Progress(lambda f, info: seen["j"].append((f, info)))
    tp = tprog.Progress(lambda f, info: seen["t"].append((f, info)))
    for i in range(4):
        assert jp(i, 4, mass=1.5) == tp(i, 4, mass=1.5)
    tp.cancel()
    jp.cancel()
    assert tp.cancelled and not tp(4, 5) and not jp(4, 5)
    assert seen["t"] == seen["j"] and len(seen["t"]) == 5
    assert issubclass(tprog.Cancelled, Exception)

"""The port's general samplers and the rest of core/ against the reference,
and the regional-grid branches they open.

Tolerances, and why:

- exactly equal: ``row_roll``, ``row_sample_nearest_x(_static)``,
  ``grid_st`` and ``sample_nearest`` (integer index arithmetic
  and float32 ops in the reference's order; a gather and the reference's
  barrel roll fetch the same values);
- rtol 1e-6 (atol 1e-6 of the largest magnitude, for values that cross
  zero): ``row_sample_bilinear_x``, ``sample_bilinear``,
  ``offset_coords``, ``sample_offset_*``, ``neighborhood``, ``get_slope``,
  the grid's vector helpers and ``geodistance_tex``.  Where torch's and
  XLA's sin, cos, asin or sqrt differ they differ by an ulp;
- the regional branches, against the reference run op by op: the blur's
  GL-clamp gathers within 1e-5 of max (an ulp of cos moves a stretched
  tap's weights by ~1e-7 of a pixel, against jumps of ~4 between the
  random field's neighbours), and bit for bit with XLA's sin, cos and
  sqrt swapped in (tests/torch_xla_libm.py); the gather
  Laplacian exactly; ``advect_method="exact"`` (and any advect on a
  regional grid) within 2e-5 of max, as the ulps of atan2 and asin move
  a bilinear fetch's weights by ~1e-7 of a pixel and the random test
  velocities jump by ~20 between neighbours, and within 1e-6 of max with
  XLA's functions swapped in (pow stays torch's);
- the crater lake of tests/test_flow.py:92-107 through the port's
  ``flow_filter``: the flow map within 1e-6 of max of the reference's,
  and the reference test's own assertions.

Each sampler test runs on an x-periodic grid and on a regional one,
``coords=(-1.0, 1.0, -2.0, 2.0)``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core import fastroll as jfr
from demiurge_tpu.core import grid as jgrid
from demiurge_tpu.core import stencils as jst
from demiurge_tpu.core import topology as jtopo
from demiurge_tpu_torch.core import fastroll as tfr
from demiurge_tpu_torch.core import grid as tgrid
from demiurge_tpu_torch.core import stencils as tst
from demiurge_tpu_torch.core import topology as ttopo
from demiurge_tpu_torch.core.platform import use_cuda_kernels
from demiurge_tpu_torch.core.state import State, new_state
from torch_xla_libm import xla_libm

torch.set_num_threads(2)
PI = math.pi
CPU = torch.device("cpu")
REGIONAL = (-1.0, 1.0, -2.0, 2.0)
GRIDS = {"global": None, "regional": REGIONAL}


def _grids(name, W=48, H=24):
    coords = GRIDS[name]
    if coords is None:
        return jgrid.Grid(W, H), tgrid.Grid(W, H)
    return jgrid.Grid(W, H, coords), tgrid.Grid(W, H, coords)


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _close_to_max(got, want, frac):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _field(H, W, seed=0, batch=()):
    return np.random.default_rng(seed).standard_normal(
        (*batch, H, W)).astype(np.float32)


@pytest.mark.parametrize("name", GRIDS)
def test_row_rolls_and_samplers_x_match_reference(name):
    jg, tg = _grids(name)
    rng = np.random.default_rng(1)
    f = _field(tg.height, tg.width, batch=(2,))
    k = rng.integers(-200, 200, tg.height).astype(np.int32)
    _equal(tfr.row_roll(torch.from_numpy(f), torch.from_numpy(k)),
           jfr.row_roll(jnp.asarray(f), k))
    dx = (rng.standard_normal(tg.height) * 20).astype(np.float32)
    dx[:4] = [0.5, -0.5, 1.5, -2.5]     # the rounding edges
    _equal(tfr.row_sample_nearest_x(torch.from_numpy(f),
                                    torch.from_numpy(dx).reshape(-1, 1)),
           jfr.row_sample_nearest_x(jnp.asarray(f), dx.reshape(-1, 1)))
    _equal(tfr.row_sample_nearest_x_static(torch.from_numpy(f), dx),
           jfr.row_sample_nearest_x_static(jnp.asarray(f), dx))
    _close(tfr.row_sample_bilinear_x(torch.from_numpy(f),
                                     torch.from_numpy(dx)),
           jfr.row_sample_bilinear_x(jnp.asarray(f), dx))


@pytest.mark.parametrize("name", GRIDS)
def test_grid_st_and_sample_nearest_equal_reference(name):
    jg, tg = _grids(name)
    H, W = tg.shape
    js, jt = jtopo.grid_st(jg)
    ts, tt = ttopo.grid_st(tg, CPU)
    _equal(ts, js)
    _equal(tt, jt)
    rng = np.random.default_rng(2)
    f = _field(H, W, seed=3, batch=(4,))
    s = (rng.random((H, W)) * 1.4 - 0.2).astype(np.float32)
    t = (rng.random((H, W)) * 1.4 - 0.2).astype(np.float32)
    s[0, :3] = [0.0, 1.0, np.nextafter(np.float32(1), np.float32(0))]
    _equal(ttopo.sample_nearest(torch.from_numpy(f), torch.from_numpy(s),
                                torch.from_numpy(t)),
           jtopo.sample_nearest(jnp.asarray(f), jnp.asarray(s),
                                jnp.asarray(t)))
    _close(ttopo.sample_bilinear(torch.from_numpy(f), torch.from_numpy(s),
                                 torch.from_numpy(t)),
           jtopo.sample_bilinear(jnp.asarray(f), jnp.asarray(s),
                                 jnp.asarray(t)))


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("dx, dy", [(1.3, -2.7), (0.0, 30.0),
                                    (-3.0, -40.0), ("rows", 2.5)])
def test_offset_samplers_match_reference(name, dx, dy):
    """offset() with fractional, pole-crossing and per-row offsets, and
    both fetches at it."""
    jg, tg = _grids(name)
    f = _field(tg.height, tg.width, seed=4)
    if dx == "rows":
        dx_np = (np.random.default_rng(5).standard_normal((tg.height, 1))
                 * 5).astype(np.float32)
        jdx, tdx = jnp.asarray(dx_np), torch.from_numpy(dx_np)
    else:
        jdx = tdx = dx
    js, jt = jtopo.grid_st(jg)
    ts, tt = ttopo.grid_st(tg, CPU)
    for got, want in zip(ttopo.offset_coords(ts, tt, tdx, dy, tg),
                         jtopo.offset_coords(js, jt, jdx, dy, jg)):
        _close(got, want)
    for pole_wrap in (True, False):
        _close(ttopo.sample_offset_nearest(torch.from_numpy(f), tdx, dy, tg,
                                           pole_wrap=pole_wrap),
               jtopo.sample_offset_nearest(jnp.asarray(f), jdx, dy, jg,
                                           pole_wrap=pole_wrap))
        _close(ttopo.sample_offset_bilinear(torch.from_numpy(f), tdx, dy, tg,
                                            pole_wrap=pole_wrap),
               jtopo.sample_offset_bilinear(jnp.asarray(f), jdx, dy, jg,
                                            pole_wrap=pole_wrap))


@pytest.mark.parametrize("name", GRIDS)
def test_neighborhood_and_slope_match_reference(name):
    jg, tg = _grids(name)
    f = _field(tg.height, tg.width, seed=6) * 3
    got = ttopo.neighborhood(torch.from_numpy(f), tg)
    want = jtopo.neighborhood(jnp.asarray(f), jg)
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key])
    for z in (1.0, 40.0):
        _close(tst.get_slope(torch.from_numpy(f), tg, z),
               jst.get_slope(jnp.asarray(f), jg, z))


@pytest.mark.parametrize("name", GRIDS)
def test_grid_vector_helpers_match_reference(name):
    jg, tg = _grids(name)
    assert tg.radius == jg.radius
    rng = np.random.default_rng(8)
    s, t = (rng.random((2, 64)).astype(np.float32))
    for got, want in zip(tg.tex_to_spheric(torch.from_numpy(s),
                                           torch.from_numpy(t)),
                         jg.tex_to_spheric(jnp.asarray(s), jnp.asarray(t))):
        _close(got, want)
    s2, t2 = (rng.random((2, 64)).astype(np.float32))
    _close(tg.geodistance_tex((torch.from_numpy(s), torch.from_numpy(t)),
                              (torch.from_numpy(s2), torch.from_numpy(t2))),
           jg.geodistance_tex((jnp.asarray(s), jnp.asarray(t)),
                              (jnp.asarray(s2), jnp.asarray(t2))))

    jl, jp = jg.lam_phi()
    tl, tp = tg.lam_phi(CPU)
    _equal(tl, jl)
    _equal(tp, jp)
    vx, vy = (_field(tg.height, tg.width, seed=9, batch=(2,)))
    jv, tv = (jnp.asarray(vx), jnp.asarray(vy)), (torch.from_numpy(vx),
                                                  torch.from_numpy(vy))

    def both(fname, jargs, targs, **kw):
        got = getattr(tgrid, fname)(*targs, **kw)
        want = getattr(jgrid, fname)(*jargs, **kw)
        for g, w in zip(got, want):
            _close(g, w)
        return want, got

    jc, tc = both("spheric_to_cartesian", (jl, jp), (tl, tp))
    both("cartesian_to_spheric", jc, tc)
    jR = jgrid.rotation_matrix(0.3, (0.6, 0.0, 0.8))
    tR = tgrid.rotation_matrix(0.3, (0.6, 0.0, 0.8))
    for jrow, trow in zip(jR, tR):
        for g, w in zip(trow, jrow):
            _close(g, w)
    both("apply_rotation", (jR, jc), (tR, tc))
    both("normalize3", (jc,), (tc,), eps=1e-6)
    jw, tw = both("v_to_cartesian", (*jv, jl, jp), (*tv, tl, tp))
    both("cross3", (jc, jw), (tc, tw))
    _close(tgrid.dot3(tw, tw), jgrid.dot3(jw, jw))  # w is tangent to c
    for got, want in zip(tgrid.tangent_basis(tl, tp),
                         jgrid.tangent_basis(jl, jp)):
        for g, w in zip(got, want):
            _close(g, w)
    for sub in (False, True):
        both("cartesian_to_v", (jw, jl, jp), (tw, tl, tp),
             subtract_radial=sub)


def test_new_state_and_replace():
    tg = tgrid.Grid(16, 8)
    st = new_state(tg, CPU)
    assert st.shape == (8, 16) and st.height.dtype == torch.float32
    assert torch.equal(st.sel, torch.ones(8, 16))
    assert torch.equal(st.height, torch.zeros(8, 16))
    st2 = st.replace(sel=None, u=torch.ones(8, 16))
    assert isinstance(st2, State) and st2.u is not None and st.u is None
    assert torch.equal(st2.sel_or_ones(), torch.ones(8, 16))


def test_kernels_serve_x_periodic_grids_only():
    """The one dispatch predicate sends a regional grid to the plain twin
    whatever the device (a stand-in for a CUDA tensor: this host has
    none)."""

    @dataclasses.dataclass
    class OnCard:
        is_cuda: bool = True

    t = OnCard()
    assert use_cuda_kernels(t, t)
    assert use_cuda_kernels(t, grid=tgrid.Grid(64, 32))
    assert not use_cuda_kernels(t, grid=tgrid.Grid(64, 32, REGIONAL))
    assert not use_cuda_kernels(torch.zeros(2), grid=tgrid.Grid(64, 32))


# ---------------------------------------------------------------------------
# the regional branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [0.5, 3.0])
def test_regional_blur_matches_reference(radius):
    """The GL-clamp gather path (the reference's blur13_pass on a grid
    that is not x-periodic), through the port's ``blur`` (the kernel's
    plain twin on a regional grid)."""
    from demiurge_tpu.ops import blur as jb
    from demiurge_tpu_torch.ops import blur as tb

    jg, tg = _grids("regional", 64, 32)
    f = _field(32, 64, seed=10)
    with jax.disable_jit():
        want = jb.blur(jnp.asarray(f), jg, radius)
    _close_to_max(tb.blur(torch.from_numpy(f), tg, radius), want, 1e-5)
    with xla_libm(tb):
        _equal(tb.blur(torch.from_numpy(f), tg, radius), want)
    for direction in ((0.0, 1.3), (1.3, 0.0)):
        for stretch in (True, False):
            want = jb.blur13_pass(jnp.asarray(f), jg, direction,
                                  stretch_x=stretch)
            _close_to_max(tb.blur13_pass(torch.from_numpy(f), tg, direction,
                                         stretch_x=stretch), want, 1e-5)
            with xla_libm(tb):
                _equal(tb.blur13_pass(torch.from_numpy(f), tg, direction,
                                      stretch_x=stretch), want)


def test_regional_texture_laplacian_matches_reference():
    jg, tg = _grids("regional", 64, 32)
    f = _field(32, 64, seed=11)
    for got, want in zip(tst.texture_laplacian(torch.from_numpy(f), tg),
                         jst.texture_laplacian(jnp.asarray(f), jg)):
        _equal(got, want)


@pytest.mark.parametrize("name, method", [("global", "exact"),
                                          ("regional", "fast"),
                                          ("regional", "exact")])
def test_gather_advect_matches_reference(name, method):
    """advect_method='exact', and any advect on a regional grid: bilinear
    gathers at the backtraced coordinates, then transport and forcing."""
    from demiurge_tpu.ops import ocean as jo
    from demiurge_tpu_torch.ops import ocean as to
    from demiurge_tpu_torch.utils import interop

    jg, tg = _grids(name, 64, 32)
    rng = np.random.default_rng(12)
    u, v = (rng.standard_normal((2, 32, 64)) * 8).astype(np.float32)
    h = rng.standard_normal((32, 64)).astype(np.float32)
    jcfg = jo.OceanConfig(advect_method=method)
    tcfg = interop.ocean_config_from_dict(dataclasses.asdict(jcfg))
    want = jo.advect(jnp.asarray(u), jnp.asarray(v), jnp.asarray(h), jg,
                     jcfg)
    args = (torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(h),
            tg, tcfg)
    for g, w in zip(to.advect(*args), want):
        _close_to_max(g, w, 2e-5)
    to._TABLES.clear()  # the per-grid tables, built with XLA's functions
    try:
        with xla_libm(to):
            for g, w in zip(to.advect(*args), want):
                _close_to_max(g, w, 1e-6)
    finally:
        to._TABLES.clear()
    assert float(jnp.abs(want[0]).max()) > 0


def test_crater_lake_flow_filter_matches_reference():
    """tests/test_flow.py:92-107 through the port: an inland depression
    ringed by high ground connects over its lowest saddle, and its
    flooded floor is zeroed."""
    from demiurge_tpu.ops import flow as jf
    from demiurge_tpu_torch.ops import flow as tf

    jg, tg = _grids("regional", 32, 16)
    h = np.full((16, 32), -1.0, np.float32)       # ocean
    h[2:14, 4:28] = 5.0                            # plateau island
    h[6:10, 10:18] = 2.0                           # crater floor
    h[7, 18] = 3.0                                 # saddle in the east rim
    want = np.asarray(jf.flow_filter(
        jnp.asarray(h), jnp.ones((16, 32)), jg,
        jf.FlowConfig(preblur=0.0, exponent=1.0, lakes=True)))
    fm = tf.flow_filter(torch.from_numpy(h), torch.ones(16, 32), tg,
                        tf.FlowConfig(preblur=0.0, exponent=1.0,
                                      lakes=True)).numpy()
    np.testing.assert_allclose(fm, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert (fm[6:10, 10:18] >= 0).all()
    assert np.isfinite(fm).all()
    assert (fm > 0).sum() > 50

"""The port's map projections and appearance chain (demiurge_tpu_torch/viz)
and ``Project.render``, against the reference on the CPU.

The same seeded numpy terrain (64x32) goes through both packages; the
screen is 96x48.  Tolerances, and why:

- ``screen_to_tex``: s and t within 16 ulps of 1.0 (ATOL = 16 * 2^-23) of
  the reference's jitted form wherever neither is out of bounds.  The
  port rounds every division by a constant as the jitted reference does
  (a product with the float32 reciprocal); what is left is XLA's fused
  multiply-adds and folded constants and the two libms (an ulp each),
  grown by up to 1/cos(phi) near the poles (measured: at most 11 ulps, in
  Goode's sinusoidal band).  An out-of-bounds flag that differs must lie
  on the rim: next to a pixel whose flag differs from its own.  The
  jitted reference screens come from a fresh interpreter with JAX's
  persistent compilation cache off (the fixture ``reference_screens``).
- ``project_field`` nearest: a pixel may take another texel only where the
  port's s*W or t*H lies within W*ATOL or H*ATOL of a whole number (a
  texel edge) or on the rim; each such pixel is counted.  The 96x48
  screen puts every third pixel centre of the equirectangular view
  exactly on a texel edge, so that case flips many.  Bilinear: within
  1e-5 of max|field| plus ATOL*(W+H) texels times the field's largest
  step between neighbours.
- ``inverse_point`` and the globe's mouse position: within ATOL (the
  reference runs them op by op, with true divisions; the port's 0-d path
  does too); the drag's new rotation within 2*pi*2*ATOL.
- Layers alone and chained (``appearance.render``, eager in the
  reference too): within 1e-5.  The masks with thresholds (the brush
  outline's rim, the vector field's arrow body and head) may flip; each
  flipped pixel is counted and lies within 1e-4 of its threshold.
- ``to_png``: the bytes equal the reference's.
- ``Project.render`` on a 64x32 session: as ``project_field`` nearest,
  the colours compared within 1e-5.
"""

import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.api import Project as JProject
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.viz import appearance as ja
from demiurge_tpu.viz import projections as jp
from demiurge_tpu_torch.api import Project as TProject
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.viz import appearance as ta
from demiurge_tpu_torch.viz import projections as tp

torch.set_num_threads(2)

W, H, OW, OH = 64, 32, 96, 48
ATOL = 16 * 2.0 ** -23
LAYER_TOL = 1e-5
# Goode's interrupted lobes, (north bounds, centres, south bounds, centres)
LOBES = ((-180, -40, 180), (-100, 30), (-180, -100, -20, 80, 180),
         (-160, -60, 20, 140))
GLOBE = (0.3, 1.2)

CASES = [(n, {}) for n in jp.PROJECTIONS] + [
    ("goode", {"interruptions": LOBES}),
    ("mollweide", {"interruptions": LOBES}),
    ("orthographic", {"ortho_state": GLOBE}),
    ("hammer", {"rotation": (0.4, 0.3, 0.2), "zoom": 0.8}),
    ("img", {"zoom": 0.8, "offset": (0.3, -0.2)}),
]
IDS = [n + ("" if not kw else "-" + "-".join(kw)) for n, kw in CASES]


def _params(name, kw):
    kw = dict(kw)
    kw.setdefault("window_aspect", 2.0)
    return (jp.CanvasParams(projection=name, **kw),
            tp.CanvasParams(projection=name, **kw))


def _terrain(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(4):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    h = (h - h.min()) / (h.max() - h.min())
    return (h * 10.0 - 4.0).astype(np.float32)   # [-4, 6], as the CLI's


def _uv(seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((H, W)).astype(np.float32) * 3
                 for _ in range(2))


_jit_screen = jax.jit(jp.screen_to_tex, static_argnums=(0, 1, 2, 3))

# every case's jitted reference screen, computed in a fresh interpreter
# (argv: this directory, the output .npz)
_REFERENCE_SCREENS = """
import sys
import jax
import numpy as np
jax.config.update("jax_default_matmul_precision", "highest")
sys.path.insert(0, sys.argv[1])
import test_torch_viz as tv
out = {}
for (name, kw), case in zip(tv.CASES, tv.IDS):
    jpar, _ = tv._params(name, kw)
    screen = tv._jit_screen(jpar, tv.JGrid(tv.W, tv.H), tv.OW, tv.OH)
    for i, a in enumerate(screen):
        out[f"{case}/{i}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_screens(tmp_path_factory):
    """The reference's jitted ``screen_to_tex`` of every case, computed
    once in a fresh interpreter with JAX's persistent compilation cache
    off, so that nothing an earlier test file left in this worker and no
    executable another process or run wrote to the shared cache reaches
    the reference: the two inputs of this comparison that can differ
    from run to run of the suite (the one failure seen in a parallel run
    of the whole suite was not reproduced alone or in order)."""
    here = pathlib.Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("screens") / "screens.npz"
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_ENABLE_COMPILATION_CACHE="false", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _REFERENCE_SCREENS, str(here),
                    str(out)], env=env, cwd=here.parent, check=True,
                   timeout=600)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port_screen(name, kw):
    _, tpar = _params(name, kw)
    return [a.numpy() for a in tp.screen_to_tex(tpar, TGrid(W, H), OW, OH,
                                                "cpu")]


def _screens(name, kw, reference):
    case = IDS[CASES.index((name, kw))]
    return ([reference[f"{case}/{i}"] for i in range(3)],
            _port_screen(name, kw))


def _on_rim(oob):
    """Pixels with a 4-neighbour of the other out-of-bounds value."""
    p = np.pad(oob, 1, mode="edge")
    return ((p[1:-1, :-2] != oob) | (p[1:-1, 2:] != oob)
            | (p[:-2, 1:-1] != oob) | (p[2:, 1:-1] != oob))


def _near_edge(x, n):
    """Whether x*n lies within n*ATOL of a whole number."""
    xn = x.astype(np.float64) * n
    return np.abs(xn - np.round(xn)) <= n * ATOL


@pytest.mark.parametrize("name, kw", CASES, ids=IDS)
def test_screen_to_tex_matches_jitted_reference(name, kw, reference_screens):
    (js, jt, jo), (ts, tt, to) = _screens(name, kw, reference_screens)
    assert ts.shape == tt.shape == to.shape == (OH, OW)
    assert ts.dtype == np.float32 and to.dtype == np.bool_
    flips = jo != to
    off_rim = flips & ~(_on_rim(jo) & _on_rim(to))
    assert not off_rim.any(), [(int(r), int(c), float(ts[r, c]),
                                float(js[r, c]), float(tt[r, c]),
                                float(jt[r, c]))
                               for r, c in np.argwhere(off_rim)[:8]]
    valid = ~jo & ~to
    assert valid.sum() > OW * OH // 2
    np.testing.assert_allclose(ts[valid], js[valid], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt[valid], jt[valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("bilinear", [False, True], ids=["nearest",
                                                         "bilinear"])
@pytest.mark.parametrize("name, kw", CASES, ids=IDS)
def test_project_field_matches_reference(name, kw, bilinear):
    h = _terrain()
    jpar, tpar = _params(name, kw)
    jimg, joob = (np.asarray(a) for a in jp.project_field(
        jnp.asarray(h), jpar, JGrid(W, H), OW, OH, bilinear=bilinear))
    timg, toob = tp.project_field(torch.from_numpy(h), tpar, TGrid(W, H),
                                  OW, OH, bilinear=bilinear)
    timg, toob = timg.numpy(), toob.numpy()
    assert timg.shape == (OH, OW) and timg.dtype == np.float32
    rim = (joob != toob)
    assert not (rim & ~_on_rim(toob)).any()
    both = ~joob & ~toob
    np.testing.assert_array_equal(timg[joob & toob], 0.0)
    if bilinear:
        step = max(np.abs(np.diff(h, axis=0)).max(),
                   np.abs(np.diff(h, axis=1)).max())
        tol = LAYER_TOL * np.abs(h).max() + ATOL * (W + H) * step
        np.testing.assert_allclose(timg[both], jimg[both], rtol=0, atol=tol)
        return
    ts, tt, _ = _port_screen(name, kw)
    edge = _near_edge(ts, W) | _near_edge(tt, H)
    off = both & (timg != jimg)
    assert not (off & ~edge).any(), int((off & ~edge).sum())
    assert off.sum() <= (both & edge).sum()


@pytest.mark.parametrize("name, kw", [c for c in CASES
                                      if "ortho_state" not in c[1]],
                         ids=[i for i, c in zip(IDS, CASES)
                              if "ortho_state" not in c[1]])
def test_inverse_point_matches_reference(name, kw):
    jpar, tpar = _params(name, kw)
    pts = [(0.5, 0.5), (0.1, 0.2), (0.8, 0.35), (0.33, 0.9), (0.02, 0.5),
           (0.97, 0.03), (0.6, 0.61)]
    hits = 0
    for sx, sy in pts:
        want = jp.inverse_point(jpar, JGrid(W, H), sx, sy)
        got = tp.inverse_point(tpar, TGrid(W, H), sx, sy)
        assert (want is None) == (got is None), (sx, sy, want, got)
        if want is not None:
            hits += 1
            assert all(isinstance(v, float) for v in got)
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert hits >= 3


def test_orthographic_mouse_pos_and_drag():
    jg, tg = JGrid(W, H), TGrid(W, H)
    jpar, tpar = _params("orthographic", {"ortho_state": GLOBE})
    for sx, sy in [(0.5, 0.5), (0.3, 0.4), (0.7, 0.45), (0.55, 0.2),
                   (0.95, 0.95)]:
        want = jp.orthographic_mouse_pos(jpar, jg, sx, sy)
        got = tp.orthographic_mouse_pos(tpar, tg, sx, sy)
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for start in (jpar, jp.CanvasParams(projection="orthographic",
                                        window_aspect=2.0)):
        tstart = tp.CanvasParams(**{f: getattr(start, f)
                                    for f in start.__dataclass_fields__})
        want = jp.orthographic_drag(start, jg, (0.45, 0.5), (0.6, 0.55))
        got = tp.orthographic_drag(tstart, tg, (0.45, 0.5), (0.6, 0.55))
        assert got.ortho_state != tstart.ortho_state
        np.testing.assert_allclose(got.ortho_state, want.ortho_state,
                                   rtol=0, atol=2 * math.pi * 2 * ATOL)
    # a drag off the globe leaves the params as they were
    assert tp.orthographic_drag(tpar, tg, (0.5, 0.5), (0.99, 0.99)) is tpar
    r = tp.rotation_matrix_euler(0.4, 0.3, 0.2)
    np.testing.assert_array_equal(r, jp.rotation_matrix_euler(0.4, 0.3, 0.2))


# ---------------------------------------------------------------------------
# the appearance chain
# ---------------------------------------------------------------------------


def test_gradient_lut_and_sample_lut():
    for presets in (ja.LAND_PRESETS, ja.OCEAN_PRESETS):
        for name, colors in presets.items():
            np.testing.assert_array_equal(ta.gradient_lut(colors),
                                          ja.gradient_lut(colors))
    assert ta.LAND_PRESETS == ja.LAND_PRESETS
    assert ta.OCEAN_PRESETS == ja.OCEAN_PRESETS
    lut = ja.gradient_lut(ja.LAND_PRESETS["atlas"])
    x = np.linspace(-0.2, 1.2, 1001).astype(np.float32)
    np.testing.assert_array_equal(
        ta.sample_lut(lut, torch.from_numpy(x)).numpy(),
        np.asarray(ja.sample_lut(lut, jnp.asarray(x))))


def _layers(m, sel, kind):
    return {
        "elevation": m.ElevationMap(land="atlas", ocean="deep"),
        "hillshade": m.Hillshade(),
        "hillshade-multi": m.Hillshade(multidirectional=True, z_factor=20.0),
        "slope": m.SlopeMap(z_factor=30.0),
        "aspect": m.AspectMap(),
        "graticules": m.Graticules(interval=20.0),
        "brush": m.BrushOutline(center=(0.3, 0.6), size=9.0),
        "selection": m.SelectionOutline(sel=sel, time=0.25),
        "dim": m.UnselectedDim(sel=sel),
        "arrows": m.VectorField(spacing=8),
        "arrows-scaled": m.VectorField(spacing=12, scale=6.0,
                                       color=(0.9, 0.1, 0.1, 0.7)),
    }[kind]


LAYERS = ["elevation", "hillshade", "hillshade-multi", "slope", "aspect",
          "graticules", "brush", "selection", "dim", "arrows",
          "arrows-scaled"]


def _threshold_margin(kind, h, uv):
    """Per pixel, how near the layer's mask is to flipping (float64):
    the brush outline's distance tests, the arrows' body and head tests."""
    tg = TGrid(W, H)
    if kind == "brush":
        layer = _layers(ta, None, kind)
        s = torch.from_numpy(((np.arange(W) + 0.5) / W)[None].repeat(H, 0))
        t = torch.from_numpy(((np.arange(H) + 0.5) / H)[:, None]
                             .repeat(W, 1))
        r = tg.geodistance_tex((s, t), layer.center).numpy()
        delta = 2 * np.hypot(np.roll(r, -1, 1) - r, np.roll(r, -1, 0) - r)
        return np.minimum(np.abs(r - layer.size),
                          np.abs(r - (layer.size - delta)))
    layer = _layers(ta, None, kind)
    u, v = (a.astype(np.float64) for a in uv)
    sp, rad = layer.spacing, layer.spacing / 2.0
    r = np.arange(H)[:, None]
    c = np.arange(W)[None]
    ly, lx = (r % sp) - rad + 0.5, (c % sp) - rad + 0.5
    cr = np.clip((r // sp) * sp + sp // 2, 0, H - 1)
    cc = np.clip((c // sp) * sp + sp // 2, 0, W - 1)
    uc, vc = u[cr, cc], v[cr, cc]
    vmax = layer.scale or np.sqrt(u * u + v * v).max()
    value = np.clip(np.hypot(uc, vc) / vmax, 0, 1)
    th = np.arctan2(uc, vc)
    rx = np.cos(th) * lx - np.sin(th) * ly
    ry = np.sin(th) * lx + np.cos(th) * ly
    k = rad - 1
    tests = [np.abs(rx) - rad * 0.075 * np.sqrt(value),
             np.abs(ry) - (k * value - k * 0.3), ry - k * value,
             ry - (k * value - k * 0.3),
             np.abs(ry - k * value) * np.sqrt(value) - np.abs(rx),
             value - 0.05]
    return np.min(np.abs(tests), axis=0)


@pytest.mark.parametrize("kind", LAYERS)
def test_layer_matches_reference(kind):
    h = _terrain()
    uv = _uv()
    sel = (h > 0.5).astype(np.float32)
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    jl = _layers(ja, jnp.asarray(sel), kind)
    tl = _layers(ta, torch.from_numpy(sel), kind)
    jg, tg = JGrid(W, H), TGrid(W, H)
    if kind.startswith("arrows"):
        want = jl(jnp.asarray(img), tuple(map(jnp.asarray, uv)), jg)
        got = tl(torch.from_numpy(img), tuple(map(torch.from_numpy, uv)), tg)
    else:
        want = jl(jnp.asarray(img), jnp.asarray(h), jg)
        got = tl(torch.from_numpy(img), torch.from_numpy(h), tg)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (H, W, 4) and got.dtype == np.float32
    off = np.abs(got - want).max(-1) > LAYER_TOL
    if kind in ("brush", "arrows", "arrows-scaled"):
        margin = _threshold_margin(kind, h, uv)
        assert not (off & (margin > 1e-4)).any(), int(off.sum())
        assert off.sum() <= (margin <= 1e-4).sum()
    else:
        assert not off.any(), (kind, float(np.abs(got - want).max()))
    if kind in ("brush", "selection", "arrows", "arrows-scaled"):
        assert (np.abs(got - img).max(-1) > 0.01).any()   # it drew


@pytest.mark.parametrize("chain", ["default", "all"])
def test_render_matches_reference(chain):
    h = _terrain()
    uv = _uv()
    sel = (h > 0.5).astype(np.float32)
    kinds = [k for k in LAYERS if not k.startswith(("brush", "arrows"))] \
        + ["arrows"]
    jl = None if chain == "default" else [
        _layers(ja, jnp.asarray(sel), k) for k in kinds]
    tl = None if chain == "default" else [
        _layers(ta, torch.from_numpy(sel), k) for k in kinds]
    want = np.asarray(ja.render(jnp.asarray(h), JGrid(W, H), jl,
                                uv=tuple(map(jnp.asarray, uv))))
    got = ta.render(torch.from_numpy(h), TGrid(W, H), tl,
                    uv=tuple(map(torch.from_numpy, uv))).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    off = np.abs(got - want).max(-1) > LAYER_TOL
    if chain == "all":
        assert not (off & (_threshold_margin("arrows", h, uv) > 1e-4)).any()
    else:
        assert not off.any()


def test_to_png_bytes_equal_reference(tmp_path):
    h = _terrain()
    img = ta.render(torch.from_numpy(h), TGrid(W, H))
    ta.to_png(img, tmp_path / "port.png")
    ja.to_png(img.numpy(), str(tmp_path / "ref.png"))
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "ref.png").read_bytes()
    ta.to_png(torch.from_numpy(h[:4, :6] / 6), tmp_path / "gray.png")
    ja.to_png(h[:4, :6] / 6, str(tmp_path / "gray_ref.png"))
    assert (tmp_path / "gray.png").read_bytes() == \
        (tmp_path / "gray_ref.png").read_bytes()


@pytest.mark.parametrize("projection, kw", [
    ("equirectangular", {}), ("mollweide", {}),
    ("goode", {"interruptions": LOBES}), ("orthographic",
                                          {"ortho_state": GLOBE})],
    ids=["equirectangular", "mollweide", "goode-lobes", "globe"])
def test_project_render_matches_reference(projection, kw,
                                          reference_screens):
    """A 64x32 session with terrain and currents, rendered through every
    layer but the brush by both packages."""
    h = _terrain(3)
    u, v = _uv(4)
    sel = (h > 0.5).astype(np.float32)
    jpr, tpr = JProject(W, H), TProject(W, H, device="cpu")
    jpr.terrain, tpr.terrain = jnp.asarray(h), torch.from_numpy(h)
    jpr.ocean_uv = (jnp.asarray(u), jnp.asarray(v))
    tpr.ocean_uv = (torch.from_numpy(u), torch.from_numpy(v))
    kinds = [k for k in LAYERS if k not in ("brush", "arrows-scaled")]
    jl = [_layers(ja, jnp.asarray(sel), k) for k in kinds]
    tl = [_layers(ta, torch.from_numpy(sel), k) for k in kinds]
    args = dict(projection=projection, out_w=OW, out_h=OH,
                window_aspect=2.0, **kw)
    want = np.asarray(jpr.render(layers=jl, **args))
    got = tpr.render(layers=tl, **args)
    assert got.shape == (OH, OW, 4) and got.dtype == torch.float32
    got = got.numpy()
    (_, _, joob), (ts, tt, toob) = _screens(projection, kw,
                                            reference_screens)
    np.testing.assert_array_equal(got[toob & joob],
                                  np.broadcast_to(np.float32(
                                      [0.1, 0.1, 0.1, 1.0]),
                                      got[toob & joob].shape))
    # a pixel off by more than the layers' tolerance took another texel
    # (at a texel edge), sits on the rim, or samples an arrow's threshold
    arrows = _threshold_margin("arrows", h, (u, v)) <= 1e-4
    cols = np.clip(np.floor(ts * W).astype(int), 0, W - 1)
    rows = np.clip(np.floor(tt * H).astype(int), 0, H - 1)
    explained = (_near_edge(ts, W) | _near_edge(tt, H) | _on_rim(toob)
                 | arrows[rows, cols])
    off = np.abs(got - want).max(-1) > LAYER_TOL
    assert not (off & ~explained).any(), int((off & ~explained).sum())


@pytest.mark.parametrize("example", ["make_planet", "ocean_climate"])
def test_examples_run_on_the_cpu(example, tmp_path, capsys):
    """Both examples end to end at 64x32 with a few iterations: the PNG
    (2W x W, the four channels, the map on its half) and, for
    make_planet, the session npz, which loads back into the reference's
    Project."""
    import importlib

    from demiurge_tpu_torch.utils import png as tpng

    mod = importlib.import_module(f"demiurge_tpu_torch.examples.{example}")
    out = tmp_path / f"{example}.png"
    argv = {"make_planet": ["--erosion-iters", "2", "--projection",
                            "mollweide"],
            "ocean_climate": ["--ocean-steps", "2", "--jacobi", "40",
                              "--climate-substeps", "10"]}[example]
    p, img = mod.main(["--size", str(W), str(H), "--out", str(out),
                       "--device", "cpu"] + argv)
    assert img.shape == (W, 2 * W, 4)
    png = tpng.read_png(out)
    assert png.shape == (W, 2 * W, 4)
    assert bool(torch.isfinite(p.terrain).all())
    assert "wrote" in capsys.readouterr().out
    # the map covers the middle half of the screen (window aspect 1), the
    # background (0.1, 0.1, 0.1) the rest
    mapped = np.abs(png[..., :3] - 0.1).max(-1) > 0.02
    assert 0.3 < mapped.mean() < 0.7
    if example == "make_planet":
        q = JProject.load(str(out.with_suffix(".npz")))
        np.testing.assert_array_equal(np.asarray(q.terrain),
                                      p.terrain.numpy())

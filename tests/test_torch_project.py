"""The port's editor session (api/project.py) against the reference's, at
64x32: one session through both packages, terrain and selection compared
after every step and through undo and redo; the snapshot codec, the PNG
codec and the npz checkpoints across the two packages.

The reference runs op by op (``jax.disable_jit``), except the flow map,
the erosion and the Jacobi ocean step, which run jitted: the port's
direction codes follow the compiled tie-break hash (ROADMAP queue 3), and
the jitted ocean is its tested form (tests/test_torch_ocean.py).

Tolerances, and why:

- Each step: the terrain and the selection within 1e-5 of the field's max
  at all but 1% of the pixels (measured: every pixel up to the flow map;
  the brush's LUT fetches and the lasso's edges are the ulps before it).
  From the flow map on, a direction tie moves a patch of pixels
  (tests/test_torch_erosion_loop.py), and tectonics fetches nearest taps
  at coordinates from atan2 (tests/test_torch_tectonics.py): still 1%.
  DeTerrace, last: 5% (its float32 thin-plate splines are
  ill-conditioned, so the two LU libraries differ after the clamp,
  tests/test_torch_deterrace.py).
- The ocean's u and v within 1e-4 of max (the CG step's pressure is
  within 1e-4 of max|p|, tests/test_torch_pressure_cg.py), the
  temperature within 1e-5 of max.
- Undo: each state within the codec's accuracy of the state before the
  step, accumulated (1e-6 an entry, plus the float32 rounding of the add:
  k * (1e-6 + 4 eps max|field|) after k undos); after undoing everything
  the terrain is 0 and the selection 1 within that bound.  Redo: back to
  each forward state within the same bound.
- The snapshot codec and the PNG encoder: byte for byte equal to the
  reference's; each package decodes the other's blobs.  The npz
  checkpoint round trip and the cross-package loads: exact.
"""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.api import Project as JProject
from demiurge_tpu.native import snapc as jsnap
from demiurge_tpu.ops import brush as jbrush
from demiurge_tpu.ops import noise as jnoise
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu.utils import png as jpng
from demiurge_tpu_torch.api import Project as TProject
from demiurge_tpu_torch.native import build as nbuild
from demiurge_tpu_torch.native import snapc as tsnap
from demiurge_tpu_torch.ops import brush as tbrush
from demiurge_tpu_torch.ops import noise as tnoise
from demiurge_tpu_torch.ops import ocean as tocean
from demiurge_tpu_torch.utils import png as tpng

torch.set_num_threads(2)

W, H = 64, 32
EPS32 = float(np.finfo(np.float32).eps)

REF = types.SimpleNamespace(noise=jnoise, brush=jbrush, ocean=jocean,
                            xp=jnp)
PORT = types.SimpleNamespace(noise=tnoise, brush=tbrush, ocean=tocean,
                             xp=torch)

# a stroke across the dateline, within 10 degrees of the north pole
STROKE = [(0.9, 0.55), (0.97, 0.7), (0.03, 0.85), (0.12, 0.945),
          (0.25, 0.9), (0.3, 0.8)]
LASSO = [(0.1, 0.2), (0.5, 0.3), (0.45, 0.8), (0.2, 0.7), (0.15, 0.4)]

# name, step(project, package namespace), share bound, reference jitted
STEPS = [
    ("ridged noise", lambda p, m: p.gradient_noise(m.noise.NoiseParams(
        mode="ridged", octaves=4, scale=1.5, min=-8.0, max=4.0, seed=7)),
     0.01, False),
    ("jordan noise added", lambda p, m: p.gradient_noise(m.noise.NoiseParams(
        mode="jordan", octaves=3, scale=2.0, min=-0.5, max=0.5, seed=3),
        "add"), 0.01, False),
    ("brush stroke", lambda p, m: p.brush_stroke(STROKE, m.brush.BrushParams(
        size=6.0, value=0.8, hardness=0.3)), 0.01, False),
    ("select height", lambda p, m: p.select_height(0.0, 1.0), 0.01, False),
    ("select lasso", lambda p, m: p.select_lasso(LASSO, "add"), 0.01, False),
    ("select grow", lambda p, m: p.select_grow(1), 0.01, False),
    ("select border", lambda p, m: p.select_border(2), 0.01, False),
    ("select blur", lambda p, m: p.select_blur(2), 0.01, False),
    ("blur", lambda p, m: p.blur(2.0), 0.01, False),
    ("select invert", lambda p, m: p.select_invert(), 0.01, False),
    ("select shrink", lambda p, m: p.select_shrink(1), 0.01, False),
    ("select all", lambda p, m: p.select_all(), 0.01, False),
    ("thermal erosion", lambda p, m: p.thermal_erosion(1), 0.01, False),
    ("morphology", lambda p, m: p.morphology(1, "max"), 0.01, False),
    ("offset", lambda p, m: p.offset(-1.5), 0.01, False),
    ("scale", lambda p, m: p.scale(1.2), 0.01, False),
    ("flow map", lambda p, m: p.flow_map(), 0.01, True),
    ("undo flow map", lambda p, m: p.undo(), 0.01, False),
    ("landscape evolution", lambda p, m: p.landscape_evolution(iterations=2),
     0.01, True),
    ("ocean (Jacobi)", lambda p, m: p.ocean_currents(1, m.ocean.OceanConfig(
        jacobi_iters=200, diffusion_iters=10)), 0.01, True),
    ("ocean (CG)", lambda p, m: p.ocean_currents(1, m.ocean.OceanConfig(
        diffusion_iters=10, pressure_method="cg")), 0.01, False),
    ("temperature", lambda p, m: p.temperature_sim(10, write_terrain=False),
     0.01, False),
    ("tectonics", lambda p, m: p.tectonics(steps=1), 0.01, False),
    ("quantise to 0.25", lambda p, m: p._apply_terrain(
        m.xp.round(p.terrain / 0.25) * 0.25), 0.01, False),
    ("deterrace", lambda p, m: p.deterrace(), 0.05, False),
]
NAMES = [s[0] for s in STEPS]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _state(p):
    out = {"terrain": _np(p.terrain), "sel": _np(p.sel)}
    if getattr(p, "ocean_uv", None) is not None:
        out["u"], out["v"] = (_np(a) for a in p.ocean_uv)
    if getattr(p, "temperature", None) is not None:
        out["T"] = _np(p.temperature)
    return out


def _drive(p, pkg, reference):
    """The session forward, then undo everything, then redo everything;
    the state after each step of each pass."""
    forward, undone, redone = [], [], []
    # the state at each undo entry's boundary: entry k takes before[k] to
    # before[k + 1]
    before = [_state(p)]
    for name, step, _, jitted in STEPS:
        n = len(p.undo_stack)
        if reference and not jitted:
            with jax.disable_jit():
                step(p, pkg)
        else:
            step(p, pkg)
        forward.append(_state(p))
        if len(p.undo_stack) > n:
            before.append(forward[-1])
        elif len(p.undo_stack) < n:
            before.pop()
    n_entries = len(p.undo_stack)
    while p.undo():
        undone.append(_state(p))
    while p.redo():
        redone.append(_state(p))
    return dict(forward=forward, undone=undone, redone=redone,
                before=before, n_entries=n_entries, project=p)


@pytest.fixture(scope="module")
def sessions():
    return (_drive(JProject(W, H), REF, True),
            _drive(TProject(W, H, device="cpu"), PORT, False))


def _off_share(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float((np.abs(got - want) > rel * scale).mean())


@pytest.mark.parametrize("k", range(len(STEPS)), ids=NAMES)
def test_session_step_matches_reference(sessions, k):
    ref, port = sessions
    want, got = ref["forward"][k], port["forward"][k]
    bound = STEPS[k][2]
    for field in ("terrain", "sel"):
        assert np.isfinite(got[field]).all()
        share = _off_share(got[field], want[field])
        print(f"{NAMES[k]}: {field} beyond 1e-5 of max at {share:.4f} of "
              f"the pixels")
        assert share <= bound, field
    for field, rel in (("u", 1e-4), ("v", 1e-4), ("T", 1e-5)):
        if field in want:
            assert np.isfinite(got[field]).all()
            scale = np.abs(want[field]).max()
            np.testing.assert_allclose(got[field], want[field], rtol=0,
                                       atol=rel * scale, err_msg=field)


def test_session_exercises_its_fields(sessions):
    """The steps change what they should: the ocean moves water, the
    selection steps leave a fractional selection, every entry undoable."""
    _, port = sessions
    f = port["forward"]
    assert np.abs(f[NAMES.index("ocean (CG)")]["u"]).max() > 0
    sel_blur = f[NAMES.index("select blur")]["sel"]
    assert ((sel_blur > 0) & (sel_blur < 1)).any()
    assert (f[0]["terrain"] > 0).mean() > 0.2
    assert (f[0]["terrain"] <= 0).mean() > 0.2


def _codec_bound(k, states):
    scale = max(float(np.abs(s[f]).max()) for s in states
                for f in ("terrain", "sel"))
    return k * (1e-6 + 4 * EPS32 * max(scale, 1.0))


@pytest.mark.parametrize("which", ["port", "reference"])
def test_undo_redo_round_trip(sessions, which):
    run = sessions[1] if which == "port" else sessions[0]
    before = run["before"]
    # every terrain and selection step pushed an entry; the undo of the
    # flow map popped one, and the simulations that keep their state
    # apart (two ocean steps, the temperature) pushed none
    assert run["n_entries"] == len(STEPS) - 2 - 3
    assert len(before) == run["n_entries"] + 1
    assert len(run["undone"]) == len(run["redone"]) == run["n_entries"]
    # undo k lands on the state before the k-th newest entry
    for k, got in enumerate(run["undone"], start=1):
        want = before[-1 - k]
        bound = _codec_bound(k, before)
        for f in ("terrain", "sel"):
            assert np.abs(got[f] - want[f]).max() <= bound, (k, f)
    last = run["undone"][-1]
    bound = _codec_bound(run["n_entries"], before)
    assert np.abs(last["terrain"]).max() <= bound
    assert np.abs(last["sel"] - 1).max() <= bound
    for k, got in enumerate(run["redone"], start=1):
        want = before[k]
        for f in ("terrain", "sel"):
            assert np.abs(got[f] - want[f]).max() <= 2 * bound, (k, f)


def test_undo_redo_port_matches_reference(sessions):
    """Through undo and redo the two sessions stay as close as their
    forward states were (each package undoes its own diffs)."""
    ref, port = sessions
    scale = {f: max(float(np.abs(s[f]).max()) for s in ref["forward"])
             for f in ("terrain", "sel")}
    for key in ("undone", "redone"):
        for want, got in zip(ref[key], port[key]):
            for f in ("terrain", "sel"):
                off = np.abs(got[f] - want[f]) > 1e-5 * scale[f]
                assert off.mean() <= 0.05, (key, f)


def test_npz_round_trip_and_cross_package(sessions, tmp_path):
    ref, port = sessions
    jp, tp = ref["project"], port["project"]
    tp.add_layer("ridges_2", tp.terrain * 0.5)
    tp.save(tmp_path / "port.npz")
    jp.save(tmp_path / "ref.npz")
    for path in ("port.npz", "ref.npz"):
        for load in (lambda f: TProject.load(f, device="cpu"), JProject.load):
            q = load(tmp_path / path)
            src = tp if path == "port.npz" else jp
            np.testing.assert_array_equal(_np(q.terrain), _np(src.terrain))
            np.testing.assert_array_equal(_np(q.sel), _np(src.sel))
            assert tuple(q.grid.coords) == tuple(src.grid.coords)
            assert q.grid.circumference == src.grid.circumference
            assert sorted(q.layers) == sorted(src.layers)
            for lid, layer in src.layers.items():
                assert q.layers[lid].name == layer.name
                np.testing.assert_array_equal(_np(q.layers[lid].data),
                                              _np(layer.data))
            assert q._next_layer_id == max(src.layers) + 1
    assert isinstance(TProject.load(tmp_path / "ref.npz",
                                    device="cpu").terrain, torch.Tensor)


@pytest.mark.parametrize("accuracy", [1e-6, 1e-3, 0.0])
def test_snapshot_codec_bytes_equal(accuracy):
    rng = np.random.default_rng(4)
    diff = np.zeros((H, W), np.float32)
    diff[5:20, 10:40] = rng.normal(0, 2.0, (15, 30))
    blob = tsnap.compress(diff, accuracy)
    assert blob == jsnap.compress(diff, accuracy)
    assert blob[0] == (3 if accuracy == 0 else 1)
    for dec in (tsnap.decompress, jsnap.decompress):
        back = dec(blob, diff.shape)
        assert back.dtype == np.float32
        if accuracy == 0:
            np.testing.assert_array_equal(back, diff)
        else:
            assert np.abs(back - diff).max() <= accuracy / 2 + 4 * EPS32 * 2
    assert len(blob) < diff.nbytes


def test_snapshot_codec_reads_the_reference_fallback_blob():
    """The reference writes codec 2 (raw int64 deltas) when its native
    library is missing; the port reads such a blob."""
    diff = np.linspace(-1, 1, H * W, dtype=np.float32).reshape(H, W)
    q = np.round(diff.astype(np.float64) / 1e-6).astype(np.int64).ravel()
    d = np.diff(q, prepend=np.int64(0))
    blob = jsnap._HEADER.pack(2, 1e-6) + zlib.compress(d.astype("<i8")
                                                       .tobytes())
    np.testing.assert_array_equal(tsnap.decompress(blob, diff.shape),
                                  jsnap.decompress(blob, diff.shape))
    with pytest.raises(ValueError):
        tsnap.decompress(jsnap._HEADER.pack(9, 1e-6) + zlib.compress(b""),
                         (1,))


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    """No compiler: compressing raises; there is no silent numpy codec."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    nbuild.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tsnap.compress(np.ones(4, np.float32))
    finally:
        nbuild.library.cache_clear()


@pytest.mark.parametrize("bitdepth", [8, 16])
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_png_bytes_equal(tmp_path, bitdepth, channels):
    rng = np.random.default_rng(bitdepth + channels)
    shape = (H, W) if channels == 0 else (H, W, channels)
    img = rng.random(shape).astype(np.float32)
    tpng.write_png(tmp_path / "port.png", img, bitdepth=bitdepth)
    jpng.write_png(tmp_path / "ref.png", img, bitdepth=bitdepth)
    port_bytes = (tmp_path / "port.png").read_bytes()
    assert port_bytes == (tmp_path / "ref.png").read_bytes()
    back = tpng.read_png(tmp_path / "ref.png")
    np.testing.assert_array_equal(back, jpng.read_png(tmp_path / "port.png"))
    assert np.abs(back - img).max() <= 0.5 / (2 ** bitdepth - 1) + 1e-7


def test_export_and_load_heightmap_match_reference(sessions, tmp_path):
    ref, port = sessions
    jp, tp = ref["project"], port["project"]
    terrain = _np(jp.terrain)
    tp.terrain = torch.from_numpy(terrain.copy())
    tp.export_png(tmp_path / "port.png")
    jp.export_png(tmp_path / "ref.png")
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "ref.png").read_bytes()
    q = TProject(W, H, device="cpu")
    r = JProject(W, H)
    q.load_heightmap(tmp_path / "ref.png", scale=2.0, offset=-1.0)
    r.load_heightmap(str(tmp_path / "ref.png"), scale=2.0, offset=-1.0)
    np.testing.assert_array_equal(q.terrain.numpy(), np.asarray(r.terrain))
    assert q.terrain.dtype == torch.float32
    assert q.undo() and float(q.terrain.abs().max()) <= 1e-6


def test_layers_and_render():
    p = TProject(W, H, device="cpu")
    lid = p.add_layer("extra")
    assert p.layers[lid].data.shape == (H, W)
    p.remove_layer(lid)
    assert lid not in p.layers
    assert p.undo() and lid in p.layers
    assert p.redo() and lid not in p.layers
    img = p.render(out_w=32, out_h=16, projection="mollweide")
    assert img.shape == (16, 32, 4) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    # the flat terrain (0, an ocean pixel) inside the ellipse, the
    # background (0.1, 0.1, 0.1, 1) outside it
    assert float(img[8, 16, 3]) == 1.0
    np.testing.assert_array_equal(img[0, 0].numpy(),
                                  np.float32([0.1, 0.1, 0.1, 1.0]))
    with pytest.raises(KeyError):
        p._get_field("nothing")
    assert p.device == torch.device("cpu")
    assert TProject.__init__.__defaults__[-1] == "cuda"

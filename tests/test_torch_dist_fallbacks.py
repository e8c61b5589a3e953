"""The mesh paths that once ran on the gathered fields, on gloo process
groups: each now runs on this rank's block or row group
(demiurge_tpu_torch/dist/local.py, climate.py, halo.py).

For each mesh (1x2, 2x1, 2x2 and 1x4) one group of CPU processes runs
tests/torch_mesh_worker.py in its ``fallbacks`` mode on fields made here
from a numpy seed, 128 columns wide:

- a climate dispatch of 40 substeps, deeper than a row group: on a
  32-row grid (groups of 16 and 8 rows), on a 34-row grid (groups of 8
  and 9 rows on the 2x2 and 1x4 meshes) and on a grid without poles;
  and one of 9 substeps on the 34-row grid, which a 9-row group alone
  would run in one chunk and an 8-row group in two: every rank must
  chunk alike;
- the flow masks on 4-row groups, shallower than their 7-row halo (a
  grid 4 rows a rank), and the whole flow filter there and on the 34-row
  grid (its fixpoint by the halo rounds: the two-level solve needs even
  groups);
- the ``exact_quirks`` viscosity (25 sweeps: rounds of 10, 10 and 5), on
  the globe and on the grid without poles;
- a pressure solve warm-started from a field (20 sweeps: 8, 8 and 4);
- the stages of a grid that wraps in x and reaches neither pole (the
  coefficient builds, the packed masks, the flow masks, the climate):
  blocks and strips end at the grid's edge rows;
- the row-halo exchange 1.5 row groups deep.

Bounds, and why:

- every case against the port's single-device op: bit for bit, since each
  runs the op's own arithmetic on the same inputs; the D8 codes' ties
  (codes that differ) are counted and must be 0; but the flow filter's
  fixpoint on the 4-row groups, the two-level solve, whose chain sums
  reassociate f32: its accumulation within rtol 1e-5, atol 1e-7 of the
  single-device one and its drained cells exactly
  (tests/test_torch_dist.py's bound); on the 34-row grid the halo
  rounds sum in the stencil's order: bit for bit;
- against the JAX package on the CPU, tests/test_dist.py:175-181's bounds:
  the climate (rtol 1e-5, atol 1e-4), the viscosity (rtol 1e-5, atol
  1e-6), the warm-started pressure (2e-5 of max|p|, against
  ``pressure_solve(..., p0=...)``); the codes and mouths of the strips
  exactly, against the reference's passes on the same pre-blurred height;
- the traffic counters: 0 ``sharded_call``s and 0 full-field gathers on
  every rank in every case, and no gathered bytes;
- the deep row halo: exact, against slices of the whole field (NaN
  beyond its first and last row, where the strip ends).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import flow as jf
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu.ops import temperature as jtemp
from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import jacobi as kj
from demiurge_tpu_torch.kernels.flow import pack_masks
from demiurge_tpu_torch.ops import flow as tf
from demiurge_tpu_torch.ops import ocean, temperature
from demiurge_tpu_torch.ops.blur import blur

torch.set_num_threads(2)

W, H = 128, 64
WORKER = pathlib.Path(__file__).with_name("torch_mesh_worker.py")
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
IDS = ["1x2", "2x1", "2x2", "1x4"]
BAND_COORDS = (-1.2, 1.1, -np.pi, np.pi)
GRID, BAND = Grid(W, H), Grid(W, H, coords=BAND_COORDS)
CLIMATE, UNEVEN = Grid(W, 32), Grid(W, 34)
QUIRKS = ocean.OceanConfig(diffusion_iters=25, exact_quirks=True)
WARM = ocean.OceanConfig(jacobi_iters=20)


def _smooth(rng, shape, scale, shift_=0.0, n=6):
    h = rng.standard_normal(shape).astype(np.float32)
    for _ in range(n):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    return ((h + shift_) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def inputs():
    """Terrain (land and sea), currents zero on land, their divergence, a
    pressure-like warm start, a rough terrain and a selection with a
    hole, the codes and mouths of the terrain on the band grid, and for
    the small grids a temperature and a terrain (32 and 34 rows) or a
    rough height and a selection (8 and 16 rows)."""
    rng = np.random.default_rng(20)
    terrain = _smooth(rng, (H, W), 20.0, -0.05)
    land = terrain > 0
    u, v = (np.where(land, 0.0, rng.standard_normal((H, W)) * 0.3)
            .astype(np.float32) for _ in range(2))
    div = ocean.divergence(_t(u), _t(v), _t(terrain), GRID,
                           ocean.OceanConfig())
    sel = np.ones((H, W), np.float32)
    sel[20:30, 40:70] = 0.0
    hb = blur(_t(terrain), BAND, 0.5)
    code = tf.flow_directions(hb, torch.ones_like(hb), BAND)
    _, mouth, _ = tf.incoming_mask(code, BAND)
    out = {"terrain": terrain, "u": u, "v": v, "div": div.numpy(),
           "p0": _smooth(rng, (H, W), 0.05), "f": _smooth(rng, (H, W), 3.0),
           "rough": (rng.standard_normal((H, W)) * 20).astype(np.float32),
           "sel": sel, "band_code": code.numpy(),
           "band_mouth": mouth.numpy().astype(np.float32),
           "b_T": (50.0 + _smooth(rng, (H, W), 10.0)).astype(np.float32),
           "b_terrain": terrain}
    for prefix, rows in (("c", 32), ("e", 34)):
        out[f"{prefix}_T"] = (40.0 + _smooth(rng, (rows, W), 10.0)).astype(
            np.float32)
        out[f"{prefix}_terrain"] = _smooth(rng, (rows, W), 20.0, -0.05)
    for n in (2, 4):
        out[f"f{n}_h"] = (rng.standard_normal((4 * n, W)) * 20).astype(
            np.float32)
        s = np.ones((4 * n, W), np.float32)
        s[1:3, 10:30] = 0.0
        out[f"f{n}_sel"] = s
    return out


def _run_group(inputs, shape, tmp):
    ny, nx = shape
    meta = {"shape": [W, H], "band": list(BAND_COORDS)}
    np.savez(tmp / "in.npz", meta=np.asarray(json.dumps(meta)), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / "in.npz"), str(tmp),
         str(ny), str(nx), str(r), "fallbacks"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(ny * nx)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return {shape: _run_group(inputs, shape,
                              tmp_path_factory.mktemp(f"fb{shape[0]}"
                                                      f"x{shape[1]}"))
            for shape in MESHES}


def _masks(h, sel, grid):
    code = tf.flow_directions(blur(h, grid, 0.5), sel, grid)
    _, mouth, _ = tf.incoming_mask(code, grid)
    return code, mouth, pack_masks(code, mouth, grid)


@pytest.fixture(scope="module")
def single(inputs):
    """Every case through the port's single-device op."""
    i = {k: _t(v) for k, v in inputs.items()}
    t = i["terrain"]
    want = {
        "climate": temperature.temperature_step(
            i["c_T"], i["c_terrain"], 3.0, CLIMATE, substeps=40)[:1],
        "climate_uneven": temperature.temperature_step(
            i["e_T"], i["e_terrain"], 3.0, UNEVEN, substeps=40)[:1],
        "climate_odd": temperature.temperature_step(
            i["e_T"], i["e_terrain"], 3.0, UNEVEN, substeps=9)[:1],
        "flow_uneven": tf.flow_filter_device(
            i["e_terrain"], torch.ones_like(i["e_terrain"]), UNEVEN,
            return_acc=True),
        "quirks": ocean.diffusion(i["u"], i["v"], t, GRID, QUIRKS),
        "pressure_p0": (ocean.pressure_solve(i["div"], t, GRID, WARM,
                                             p0=i["p0"]),),
        "band_pcoef": kj.coefficients(i["div"], t, BAND),
        "band_dcoef": kj.diffusion_coefficients(t, BAND),
        "band_pack": (pack_masks(i["band_code"], i["band_mouth"] > 0,
                                 BAND),),
        "band_masks": _masks(i["rough"], i["sel"], BAND),
        "band_climate": temperature.temperature_step(
            i["b_T"], t, 3.0, BAND, substeps=40)[:1],
        "band_quirks": ocean.diffusion(i["u"], i["v"], t, BAND, QUIRKS)}
    for n in (2, 4):
        g = Grid(W, 4 * n)
        want[f"flow_masks/{n}"] = _masks(i[f"f{n}_h"], i[f"f{n}_sel"], g)
        want[f"flow_filter/{n}"] = tf.flow_filter_device(
            i[f"f{n}_h"], i[f"f{n}_sel"], g, return_acc=True)
    return want


CASES = ["climate", "climate_uneven", "climate_odd", "flow_masks", "flow_filter",
         "flow_uneven", "quirks", "pressure_p0", "band_pcoef", "band_dcoef",
         "band_pack", "band_masks", "band_climate", "band_quirks"]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("case", CASES)
def test_local_form_equals_single_device(runs, single, shape, case):
    """Each case's outputs bit for bit those of the single-device op; the
    codes' ties counted apart (0)."""
    out = runs[shape]
    want = single[case if case in single else
                  f"{case}/{shape[0] * shape[1]}"]
    assert case in json.loads(str(out["cases"]))
    for i, w in enumerate(want):
        got, w = out[f"{case}{i}"], w.numpy()
        assert np.isfinite(got).all()
        if case.endswith("masks") and i == 0:
            ties = int((got != w).sum())
            assert ties == 0, f"{ties} direction ties"
        if case == "flow_filter":   # the two-level solve (module docstring)
            np.testing.assert_array_equal(got < 0, w < 0)
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-7)
            continue
        np.testing.assert_array_equal(got, w.astype(got.dtype),
                                      err_msg=f"{case} output {i}")


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_local_forms_gather_no_field(runs, shape):
    """Every case, on every rank: 0 ``sharded_call``s, 0 full-field
    gathers, 0 gathered bytes; each exchanges halos instead."""
    out = runs[shape]
    cases = json.loads(str(out["cases"]))
    kinds = json.loads(str(out["traffic_kinds"]))
    n = 2 + len(kinds)
    for row in out["counts"]:
        for c, name in enumerate(cases):
            rec = row[c * n:(c + 1) * n]
            assert rec[0] == 0 and rec[1] == 0, (name, rec)
            assert rec[2 + kinds.index("gather_field")] == 0, (name, rec)
            assert rec[2 + kinds.index("permute")] > 0, (name, rec)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_rows_halo_deeper_than_a_group(runs, inputs, shape):
    """A halo of 1.5 row groups: each rank's strip is rows [lo - k,
    hi + k) of the field, from two ranks away, ending at the grid's first
    and last row (NaN beyond them, module docstring)."""
    out = runs[shape]
    D = shape[0] * shape[1]
    r, k = H // D, int(out["deep_k"])
    assert k > r
    want = np.pad(inputs["f"], ((k, k), (0, 0)), constant_values=np.nan)
    got = out["deep"].reshape(D, r + 2 * k, W)
    for g in range(D):
        np.testing.assert_array_equal(got[g], want[g * r:g * r + r + 2 * k],
                                      err_msg=f"rank {g}")


@pytest.fixture(scope="module")
def reference(inputs):
    """The JAX package's single-device ops on the CPU."""
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    jg, jband = JGrid(W, H), JGrid(W, H, coords=BAND_COORDS)
    quirks = jocean.OceanConfig(diffusion_iters=25, exact_quirks=True)
    return {
        "climate": jtemp.temperature_step(j["c_T"], j["c_terrain"], 3.0,
                                          JGrid(W, 32), substeps=40)[0],
        "climate_uneven": jtemp.temperature_step(
            j["e_T"], j["e_terrain"], 3.0, JGrid(W, 34), substeps=40)[0],
        "climate_odd": jtemp.temperature_step(
            j["e_T"], j["e_terrain"], 3.0, JGrid(W, 34), substeps=9)[0],
        "band_climate": jtemp.temperature_step(j["b_T"], j["terrain"], 3.0,
                                               jband, substeps=40)[0],
        "quirks": jocean.diffusion(j["u"], j["v"], j["terrain"], jg, quirks),
        "band_quirks": jocean.diffusion(j["u"], j["v"], j["terrain"], jband,
                                        quirks),
        "pressure_p0": jocean.pressure_solve(
            j["div"], j["terrain"], jg, jocean.OceanConfig(jacobi_iters=20),
            p0=j["p0"])}


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_local_forms_match_reference(runs, inputs, reference, shape):
    """The climates, the viscosities and the warm-started pressure against
    the JAX package at tests/test_dist.py:175-181's bounds."""
    out = runs[shape]
    for name in ("climate", "climate_uneven", "climate_odd", "band_climate"):
        np.testing.assert_allclose(out[f"{name}0"],
                                   np.asarray(reference[name]), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    for name in ("quirks", "band_quirks"):
        for i in range(2):
            np.testing.assert_allclose(out[f"{name}{i}"],
                                       np.asarray(reference[name][i]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {i}")
    want = np.asarray(reference["pressure_p0"])
    scale = np.abs(want).max()
    assert scale > 1e-6
    np.testing.assert_allclose(out["pressure_p00"] / scale, want / scale,
                               atol=2e-5)
    assert np.abs(out["quirks0"] - inputs["u"]).max() > 0


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_strip_codes_match_reference(runs, inputs, shape):
    """The codes and mouths of the 4-row groups and of the band grid's
    strips against the reference's passes on the same pre-blurred
    height, exactly."""
    out = runs[shape]
    n = shape[0] * shape[1]
    for case, g, h, sel in (
            ("flow_masks", Grid(W, 4 * n), inputs[f"f{n}_h"],
             inputs[f"f{n}_sel"]),
            ("band_masks", BAND, inputs["rough"], inputs["sel"])):
        jg = JGrid(g.width, g.height, coords=g.coords)
        hb = blur(_t(h), g, 0.5).numpy()
        jcode = jf.flow_directions(jnp.asarray(hb), jnp.asarray(sel), jg)
        _, jmouth, _ = jf.incoming_mask(jcode, jg)
        np.testing.assert_array_equal(out[f"{case}0"], np.asarray(jcode),
                                      err_msg=case)
        np.testing.assert_array_equal(out[f"{case}1"], np.asarray(jmouth),
                                      err_msg=case)
        assert (out[f"{case}0"] == 5).any() or (out[f"{case}0"] == 0).any()


def test_mesh_traffic_tool_counts_no_gather(capsys):
    """``tools.mesh_traffic``, which PERF.md's bytes come from, runs every
    case on a 1x2 group at 64x32 and reads no ``sharded_call`` and no
    field gather on either rank, and halo bytes in every case."""
    from demiurge_tpu_torch.tools import mesh_traffic

    assert mesh_traffic.main(["--mesh", "1x2", "--width", "64",
                              "--height", "32"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mesh"] == [1, 2] and len(rec["cases"]) == 5
    for name, ranks in rec["cases"].items():
        assert len(ranks) == 2
        for r in ranks:
            assert r["sharded_call"] == r["field_gathers"] == 0, name
            assert r["bytes"]["permute"] > 0, name

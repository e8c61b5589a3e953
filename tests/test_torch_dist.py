"""The port's sharded paths (demiurge_tpu_torch/dist) on gloo process
groups, against the reference and the port's single-device path.

For each mesh (1x2, 2x1, 2x2) one group of CPU processes
(tests/torch_mesh_worker.py, which imports torch and the port only) runs
every sharded path once on 128x64 fields made here from a numpy seed; this
process holds the gathered results to the JAX package on the CPU and to
the port on one device.  Bounds, and why:

- halo exchanges and row regroups: exact, against slices of the globally
  padded field built with the port's ``shift`` (the row-halo strip, which
  ends at the grid's first and last row, against the field's own rows);
- the two-level sharded flow: A within rtol 1e-5, atol 1e-7 of
  ``flow_solve_stencil`` (the chain sums reassociate f32), vis exactly;
  the halo-exchange fallback: A and vis exactly (same sums, same order);
- pressure (2e-5 of max|p|), viscosity (rtol 1e-5, atol 1e-6) and
  climate (rtol 1e-5, atol 1e-4 against the reference's XLA scan):
  tests/test_dist.py's bounds against the reference's single-device ops;
- advect (rtol 1e-4, atol 1e-6, the same file's bound): the sampler
  against the reference's sharded sampler on a JAX mesh of the same
  shape, the whole pass against the port's single-device advect (the
  reference's departure points differ by atan2/asin ulps, see
  test_torch_ocean.py);
- the cases that once ran through ``sharded_call`` (a climate deeper
  than a rank's rows, ``exact_quirks``, a warm-started pressure) run
  their local forms: bit for bit against the single-device op;
- two coupled steps on blocks against two on one device: height rtol 1e-5,
  atol 1e-6; T rtol 1e-5, atol 1e-4; u, v rtol 1e-5, atol 1e-6
  (tests/test_dist.py:175-181); on the 2x2 mesh also against the
  reference's own sharded ``coupled_step`` on a 2x2 JAX mesh, after each
  step (the height's atol plus the erosion pass's ulps, 1e-6 of max).
  That compile takes about 2 minutes on the CPU, so it runs for one mesh.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.dist.mesh import choose_mesh_shape as jchoose
from demiurge_tpu.ops import flow as jf
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu.ops import temperature as jtemp
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.core.topology import shift
from demiurge_tpu_torch.dist import mesh as dm
from demiurge_tpu_torch.ops import blur as tb
from demiurge_tpu_torch.ops import flow as tf
from demiurge_tpu_torch.ops import ocean as tocean

torch.set_num_threads(2)

W, H, K = 128, 64, 3
WORKER = pathlib.Path(__file__).with_name("torch_mesh_worker.py")
MESHES = [(1, 2), (2, 1), (2, 2)]
IDS = ["1x2", "2x1", "2x2"]
CPU = torch.device("cpu")
JACOBI, DIFFUSION, SUBSTEPS = 64, 20, 10


def _smooth(rng, scale, shift_=0.0, n=6):
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(n):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5
    return ((h + shift_) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    """Full fields, made from a seed: terrain, a random field, flow codes,
    random currents and their divergence, a temperature, sample coords."""
    rng = np.random.default_rng(0)
    tg = TGrid(W, H)
    terrain = _smooth(rng, 20.0, -0.05)
    hb = tb.blur(torch.from_numpy(terrain), tg, 0.5)
    code = tf.flow_directions(hb, torch.ones_like(hb), tg)
    _, mouth, _ = tf.incoming_mask(code, tg)
    land = terrain > 0
    u = np.where(land, 0.0, rng.standard_normal((H, W)) * 0.3)
    v = np.where(land, 0.0, rng.standard_normal((H, W)) * 0.3)
    u, v = u.astype(np.float32), v.astype(np.float32)
    cfg = tocean.OceanConfig()
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    s2, t2 = tocean._departure(tu, tv, tg, cfg)[:2]
    div = tocean.divergence(tu, tv, torch.from_numpy(terrain), tg, cfg)
    return {"f": rng.standard_normal((H, W)).astype(np.float32),
            "terrain": terrain, "code": code.numpy(),
            "mouth": mouth.numpy().astype(np.float32),
            "area": tf.cell_area_lower_edge(tg, CPU).numpy(),
            "u": u, "v": v, "div": div.numpy(), "s2": s2.numpy(),
            "t2": t2.numpy(),
            "T": (50.0 + _smooth(rng, 10.0)).astype(np.float32)}


def _run_group(inputs, shape, tmp):
    """Start the NYxNX gloo group and return rank 0's gathered results."""
    ny, nx = shape
    meta = json.dumps({"shape": [W, H], "k": K, "jacobi": JACOBI,
                       "diffusion": DIFFUSION, "substeps": SUBSTEPS})
    np.savez(tmp / "in.npz", meta=np.asarray(meta), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / "in.npz"), str(tmp),
         str(ny), str(nx), str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(ny * nx)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = dict(np.load(tmp / "out.npz"))
    out["cli"] = [json.loads(line) for line in
                  (tmp / "cli.jsonl").read_text().splitlines()]
    out["launches"] = [json.loads(line) for line in logs[0].splitlines()
                       if line.startswith('{"kernel_launches"')]
    return out


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return {shape: _run_group(inputs, shape,
                              tmp_path_factory.mktemp(f"mesh{shape[0]}"
                                                      f"x{shape[1]}"))
            for shape in MESHES}


def _blocks(padded_full, shape, ny, nx):
    """Rank (yi, xi)'s piece of a gathered mosaic of equal pieces."""
    ph, pw = shape
    return {(y, x): padded_full[y * ph:(y + 1) * ph, x * pw:(x + 1) * pw]
            for y in range(ny) for x in range(nx)}


def _padded_rows(f, k, sign=1.0):
    """The field with k rows beyond each pole from the port's shift (the
    pole wrap: flipped rows half a world round, times ``sign``)."""
    g = TGrid(W, H)
    t = torch.from_numpy(f)
    south = [sign * shift(t, 0, -j, g)[0].numpy() for j in range(k, 0, -1)]
    north = [sign * shift(t, 0, j, g)[H - 1].numpy() for j in range(1, k + 1)]
    return np.concatenate([np.stack(south), f, np.stack(north)])


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_halo_exchange_matches_padded_shift(runs, inputs, shape):
    ny, nx = shape
    h, w = H // ny, W // nx
    for name, sign in (("halo", 1.0), ("halo_neg", -1.0)):
        rows = _padded_rows(inputs["f"], K, sign)
        full = np.concatenate([rows[:, -K:], rows, rows[:, :K]], axis=1)
        got = _blocks(runs[shape][name], (h + 2 * K, w + 2 * K), ny, nx)
        for (y, x), blk in got.items():
            want = full[y * h:y * h + h + 2 * K, x * w:x * w + w + 2 * K]
            np.testing.assert_array_equal(blk, want, err_msg=f"{name} {y} {x}")


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_row_regroup_and_rows_halo_match_padded_rows(runs, inputs, shape):
    f, out = inputs["f"], runs[shape]
    D = shape[0] * shape[1]
    r = H // D
    np.testing.assert_array_equal(out["rows"], f)
    np.testing.assert_array_equal(out["rows_back"], f)
    # the strip ends at the grid's first and last row: NaN beyond them
    want = np.pad(f, ((K, K), (0, 0)), constant_values=np.nan)
    got = out["rows_strip"].reshape(D, r + 2 * K, W)
    for g in range(D):
        np.testing.assert_array_equal(got[g], want[g * r:g * r + r + 2 * K],
                                      err_msg=f"rank {g}")


@pytest.fixture(scope="module")
def stencil(inputs):
    jg = JGrid(W, H)
    A, vis, _ = jf.flow_solve_stencil(
        jnp.asarray(inputs["code"]), jnp.asarray(inputs["area"]),
        jnp.asarray(inputs["mouth"] > 0), jg)
    return np.asarray(A), np.asarray(vis)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_twolevel_flow_matches_stencil(runs, stencil, shape):
    A0, vis0 = stencil
    out = runs[shape]
    np.testing.assert_allclose(out["flow2_A"], A0, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(out["flow2_vis"], vis0)
    assert vis0.any() and A0.max() > 20 * A0[A0 > 0].min()


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_halo_flow_matches_stencil(runs, stencil, shape):
    A0, vis0 = stencil
    np.testing.assert_array_equal(runs[shape]["flowh_A"], A0)
    np.testing.assert_array_equal(runs[shape]["flowh_vis"], vis0)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_pressure_matches_single_device(runs, inputs, shape):
    cfg = jocean.OceanConfig(jacobi_iters=JACOBI, diffusion_iters=5)
    want = np.asarray(jocean.pressure_solve(jnp.asarray(inputs["div"]),
                                            jnp.asarray(inputs["terrain"]),
                                            JGrid(W, H), cfg))
    scale = np.abs(want).max() + 1e-9
    assert scale > 1e-6
    np.testing.assert_allclose(runs[shape]["pressure"] / scale, want / scale,
                               atol=2e-5)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_viscosity_matches_single_device(runs, inputs, shape):
    cfg = jocean.OceanConfig(jacobi_iters=8, diffusion_iters=DIFFUSION)
    wu, wv = jocean.diffusion(jnp.asarray(inputs["u"]),
                              jnp.asarray(inputs["v"]),
                              jnp.asarray(inputs["terrain"]), JGrid(W, H),
                              cfg)
    np.testing.assert_allclose(runs[shape]["diff_u"], np.asarray(wu),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(runs[shape]["diff_v"], np.asarray(wv),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_climate_matches_single_device(runs, inputs, shape):
    """Against the reference's XLA scan at its bound, and against the
    port's single-device climate (the same summed-Laplacian arithmetic)
    bit for bit."""
    from demiurge_tpu_torch.ops import temperature as ttemp

    T0, h = inputs["T"], inputs["terrain"]
    want, wi = jtemp.temperature_step(jnp.asarray(T0), jnp.asarray(h), 3.0,
                                      JGrid(W, H), substeps=SUBSTEPS)
    got = runs[shape]["climate"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    assert float(runs[shape]["climate_i"]) == float(wi)
    tT, _ = ttemp.temperature_step(torch.from_numpy(T0), torch.from_numpy(h),
                                   3.0, TGrid(W, H), substeps=SUBSTEPS)
    np.testing.assert_array_equal(got, tT.numpy())


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_advect_matches_single_device(runs, inputs, shape):
    """The sharded sampler against the reference's sharded sampler on a JAX
    mesh of the same shape, and the sharded advect against the port's
    single-device advect, at the reference's bound (rtol 1e-4, atol 1e-6);
    the sampler against the port's single-radius sampler bit for bit (same
    taps, same order).  Against the reference's single-device advect the
    departure points differ by the atan2/asin ulps of test_torch_ocean.py,
    so that comparison uses its bound (2e-4 of max |u|)."""
    from demiurge_tpu.dist.advect import advect_sample_sharded as jsample
    from demiurge_tpu.dist.mesh import make_mesh as jmake_mesh
    from demiurge_tpu_torch.kernels import advect as ka

    out = runs[shape]
    tg = TGrid(W, H)
    tu, tv, th = (torch.from_numpy(inputs[k]) for k in ("u", "v", "terrain"))
    s2, t2 = (torch.from_numpy(inputs[k]) for k in ("s2", "t2"))
    ju, jv = jsample(*(jnp.asarray(inputs[k]) for k in ("u", "v", "s2", "t2")),
                     JGrid(W, H), jmake_mesh(shape[0] * shape[1], shape))
    for got, want in ((out["sample_u"], ju), (out["sample_v"], jv)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-6)

    c, r = tocean._row_col(tg, CPU)
    dx = torch.clamp(s2 * W - 0.5 - c, -8, 8)
    dy = torch.clamp(t2 * H - 0.5 - r, -2, 2)
    su, sv = ka.advect_sample_tiered_plain(tu, tv, dx, dy, ka.global_meta(8),
                                           H, 2)
    np.testing.assert_array_equal(out["sample_u"], su.numpy())
    np.testing.assert_array_equal(out["sample_v"], sv.numpy())

    cfg = tocean.OceanConfig()
    pu, pv = tocean.advect(tu, tv, th, tg, cfg)
    jau, jav = jax.jit(jocean.advect, static_argnames=("grid", "cfg"))(
        jnp.asarray(inputs["u"]), jnp.asarray(inputs["v"]),
        jnp.asarray(inputs["terrain"]), JGrid(W, H), jocean.OceanConfig())
    for got, one, ref in ((out["advect_u"], pu, jau),
                          (out["advect_v"], pv, jav)):
        np.testing.assert_allclose(got, one.numpy(), rtol=1e-4, atol=1e-6)
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(got / scale, np.asarray(ref) / scale,
                                   atol=2e-4)


COUPLED_BOUNDS = {"height": (1e-5, 1e-6), "temperature": (1e-5, 1e-4),
                  "u": (1e-5, 1e-6), "v": (1e-5, 1e-6)}


def _coupled_config():
    """tests/torch_mesh_worker.py's configuration of the coupled steps."""
    from demiurge_tpu_torch.model import CoupledConfig

    return CoupledConfig(climate_substeps=2, ocean=dataclasses.replace(
        CoupledConfig().ocean, jacobi_iters=16, diffusion_iters=5))


@pytest.fixture(scope="module")
def coupled_ref(inputs):
    from demiurge_tpu_torch.model import coupled_step, init_coupled

    g = TGrid(W, H)
    cfg = _coupled_config()
    s = init_coupled(torch.from_numpy(inputs["terrain"]), g)
    for _ in range(2):
        s = coupled_step(s, g, cfg)
    return s


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_coupled_steps_match_single_device(runs, coupled_ref, shape):
    out = runs[shape]
    for name, (rtol, atol) in COUPLED_BOUNDS.items():
        np.testing.assert_allclose(out[f"coupled_{name}"],
                                   getattr(coupled_ref, name).numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
    assert float(out["coupled_t_index"]) == float(coupled_ref.t_index)
    assert np.abs(coupled_ref.u.numpy()).max() > 0


def test_sharded_coupled_steps_match_reference_mesh_step(runs, inputs):
    """The 2x2 group's two coupled steps against the reference's
    ``coupled_step(mesh=...)`` on a 2x2 JAX mesh, from the same initial
    state: how the stages fit together (which run as block forms and
    which through ``sharded_call``, their order, ``t_index``,
    ``init_coupled`` on blocks) is held to the reference's own sharded
    step, after each of the two steps, at tests/test_dist.py:175-181's
    bounds (flow_acc at the two-level solve's), the height's atol widened
    by 1e-6 of max, the erosion pass's ulps against the reference
    (test_torch_model.py).  The reference is compiled at XLA's default
    optimization level: at a lower one it resolves a direction tie of
    this smooth terrain differently."""
    from demiurge_tpu.dist import field_sharding
    from demiurge_tpu.dist.mesh import make_mesh as jmake_mesh
    from demiurge_tpu.model import CoupledConfig as JConfig
    from demiurge_tpu.model import CoupledState as JState
    from demiurge_tpu.model import coupled_step as jstep
    from demiurge_tpu_torch.model import init_coupled
    from demiurge_tpu_torch.utils import interop

    cfg = _coupled_config()
    jcfg = JConfig(climate_substeps=2, ocean=jocean.OceanConfig(
        jacobi_iters=16, diffusion_iters=5))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    start = interop.coupled_state_to_numpy(
        init_coupled(torch.from_numpy(inputs["terrain"]), TGrid(W, H)))
    jmesh = jmake_mesh(4, (2, 2))
    sh = field_sharding(jmesh)
    st = JState(**{k: jax.device_put(jnp.asarray(a), sh) if a.ndim == 2
                   else jnp.asarray(a) for k, a in start.items()})
    out = runs[(2, 2)]
    bounds = dict(COUPLED_BOUNDS, flow_acc=(1e-5, 1e-7))
    for tag in ("coupled1", "coupled"):
        st = jstep(st, JGrid(W, H), jcfg, mesh=jmesh)
        for name, (rtol, atol) in bounds.items():
            want = np.asarray(getattr(st, name))
            if name == "height":  # the erosion pass's ulps against the
                atol += 1e-6 * np.abs(want).max()  # reference's
            np.testing.assert_allclose(out[f"{tag}_{name}"], want,
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{tag} {name}")
        assert float(out[f"{tag}_t_index"]) == float(st.t_index)


@pytest.fixture(scope="module")
def cli_ref(tmp_path_factory):
    from demiurge_tpu_torch.api import cli

    log = tmp_path_factory.mktemp("cli") / "one.jsonl"
    cli.main(["coupled", "--device", "cpu", "--width", str(W), "--height",
              str(H), "--steps", "2", "--log", str(log)])
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_cli_mesh_run_matches_one_process(runs, cli_ref, shape):
    """``coupled --mesh`` reaches the sharded step: rank 0 logs the same
    numbers as a one-process run, and the two-level flow kernels' twins
    ran (the launch counters count CUDA launches only, so they stay 0 on
    the CPU)."""
    got = runs[shape]["cli"]
    assert [r["step"] for r in got] == [r["step"] for r in cli_ref] == [0, 1]
    for g, w in zip(got, cli_ref):
        for key in ("mass", "mean_T", "advect_clamped"):
            assert np.isfinite(g[key])
            assert g[key] == pytest.approx(w[key], rel=1e-5, abs=1e-7), key
    (launches,) = runs[shape]["launches"]
    assert launches["kernel_launches"]["flow_local_solve"] == 0


def test_choose_mesh_shape_matches_reference():
    for n in range(1, 17):
        assert dm.choose_mesh_shape(n) == tuple(jchoose(n))


def test_one_process_group_runs_the_mesh_step():
    """Without torchrun's environment ``initialize`` makes a one-process
    gloo group for CPU tensors; a 1x1 mesh step equals the plain step bit
    for bit."""
    import torch.distributed as dist

    from demiurge_tpu_torch.model import CoupledConfig, coupled_step, \
        init_coupled
    from demiurge_tpu_torch.utils import interop

    assert not dist.is_initialized()
    assert dm.initialize("cpu") == CPU
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = dm.make_mesh(device="cpu")
        assert mesh.shape == (1, 1) and mesh.rank == 0
        g = TGrid(64, 32)
        h = torch.from_numpy(np.random.default_rng(2).standard_normal(
            g.shape).astype(np.float32) * 2)
        cfg = CoupledConfig(climate_substeps=2, ocean=dataclasses.replace(
            CoupledConfig().ocean, jacobi_iters=8, diffusion_iters=4))
        want = coupled_step(init_coupled(h, g), g, cfg)
        arrays = interop.coupled_state_to_numpy(init_coupled(h, g))
        got = coupled_step(interop.coupled_state_blocks_from_numpy(
            arrays, mesh, CPU), g, cfg, mesh=mesh)
        got = interop.coupled_state_blocks_to_numpy(got, mesh)
        for name, arr in interop.coupled_state_to_numpy(want).items():
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
    finally:
        dist.destroy_process_group()


def test_one_process_group_fallbacks_equal_single_device():
    """The cases that once fell back to ``sharded_call`` (the climate's
    halo deeper than a rank's rows, the viscosity's exact_quirks mode, a
    warm-started pressure solve) run their local forms, gather no field
    and equal the single-device op bit for bit."""
    import torch.distributed as dist

    from demiurge_tpu_torch.ops import temperature as ttemp

    g = TGrid(64, 32)
    rng = np.random.default_rng(4)
    h, u, v, p0 = (torch.from_numpy(rng.standard_normal(g.shape).astype(
        np.float32)) for _ in range(4))
    T = 40.0 + h
    cfg = dataclasses.replace(tocean.OceanConfig(), jacobi_iters=8,
                              diffusion_iters=4, exact_quirks=True)
    dm.initialize("cpu")
    try:
        mesh = dm.make_mesh(device="cpu")
        from demiurge_tpu_torch.dist.climate import climate_sharded_supported

        assert climate_sharded_supported(g, mesh)
        dm.reset_traffic()
        pairs = [(ttemp.temperature_step(T, h, 0.0, g, substeps=40,
                                         mesh=mesh),
                  ttemp.temperature_step(T, h, 0.0, g, substeps=40)),
                 (tocean.diffusion(u, v, h, g, cfg, mesh=mesh),
                  tocean.diffusion(u, v, h, g, cfg)),
                 ((tocean.pressure_solve(u, h, g, cfg, p0=p0, mesh=mesh),),
                  (tocean.pressure_solve(u, h, g, cfg, p0=p0),))]
        tr = dm.traffic()
        assert tr["sharded_call"] == tr["field_gathers"] == 0, tr
        for got, want in pairs:
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()

"""The port's checkpoints (demiurge_tpu_torch/utils/checkpoint.py) and the
CLI's --checkpoint/--resume/--png, against the reference on the CPU.

A 64x32 coupled state (the reference's initial state from a seeded fBm,
tests/test_checkpoint.py's configuration) goes through both packages.
Bounds, and why:

- Files: a checkpoint written by either package loads in the other with
  every array equal bit for bit (the same keys, dtypes and npz format),
  single-file and sharded (the reference's 8-device directory, whose one
  file holds 8 blocks, included).
- Resume: the port's run resumed from its checkpoint equals its
  uninterrupted run bit for bit; the reference resumed from the port's
  file matches its own run from the same state within its own bound
  (rtol 1e-6, atol 1e-7, tests/test_checkpoint.py).
- Sharded, on 1x2 and 2x1 gloo groups (tests/torch_ckpt_worker.py): the
  shard files hold blocks; the same-mesh resume and the meshless assembly
  are exact; the elastic resumes (the 1x2 checkpoint onto one process and
  onto the 2x1 mesh) match an uninterrupted single-device run within the
  reference's elastic bound (rtol 2e-5, atol 1e-6).
- The CLI under a mesh: a run resumed from its checkpoint equals the
  uninterrupted mesh run bit for bit, and the one-process run within
  tests/test_dist.py's sharded bounds (height rtol 1e-5 atol 1e-6, T rtol
  1e-5 atol 1e-4, u and v rtol 1e-5 atol 1e-6).
- --png: the port renders the reference CLI's saved terrain within 1 LSB
  of the reference CLI's PNG (the chain agrees within 1e-5; a value that
  close to a rounding edge moves one step).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.api import cli as jcli
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.model import CoupledConfig as JConfig
from demiurge_tpu.model import CoupledState as JState
from demiurge_tpu.model import coupled_step as jstep
from demiurge_tpu.model import init_coupled as jinit
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu.ops.ocean import OceanConfig as JOcean
from demiurge_tpu.utils import checkpoint as jckpt
from demiurge_tpu_torch.api import cli as tcli
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.model import CoupledState, coupled_step
from demiurge_tpu_torch.utils import checkpoint as ckpt
from demiurge_tpu_torch.utils import interop
from demiurge_tpu_torch.utils import png as tpng

torch.set_num_threads(2)

W, H = 64, 32
CPU = torch.device("cpu")
FIELDS = ("height", "uplift", "sel", "u", "v", "temperature", "t_index",
          "flow_acc")
WORKER = pathlib.Path(__file__).with_name("torch_ckpt_worker.py")
MESHES = [(1, 2), (2, 1)]
MESH_IDS = ["1x2", "2x1"]
SHARDED_BOUNDS = {"height": (1e-5, 1e-6), "temperature": (1e-5, 1e-4),
                  "u": (1e-5, 1e-6), "v": (1e-5, 1e-6)}


@pytest.fixture(scope="module")
def start():
    """The reference's configuration and initial state as numpy
    (tests/test_checkpoint.py:19-24), and the port's config."""
    jcfg = JConfig(climate_substeps=2,
                   ocean=JOcean(jacobi_iters=8, diffusion_iters=2))
    h = fbm(JGrid(W, H), NoiseParams(octaves=3, scale=2.0, min=-2.0,
                                     max=3.0, seed=7))
    state = jinit(h, JGrid(W, H))
    arrays = {f: np.asarray(getattr(state, f)) for f in FIELDS}
    cfg = interop.coupled_config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, cfg, arrays


def _port_state(arrays):
    return interop.coupled_state_from_numpy(arrays, CPU)


def _steps(state, n, cfg):
    for _ in range(n):
        state = coupled_step(state, TGrid(W, H), cfg)
    return state


def _numpy(state):
    return {f.name: (None if getattr(state, f.name) is None
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def _assert_states_equal(got, want):
    got, want = _numpy(got), _numpy(want)
    assert sorted(got) == sorted(want)
    for k in got:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k,
                                          strict=True)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_interchange_with_reference(start, tmp_path, writer):
    jcfg, cfg, arrays = start
    path = str(tmp_path / "run.ckpt.npz")
    port = _steps(_port_state(arrays), 1, cfg)
    ref = JState(**{k: jnp.asarray(v) for k, v in _numpy(port).items()})
    if writer == "port":
        ckpt.save(path, port, 1, TGrid(W, H))
        got, step = jckpt.load(path, JState)
        want = ref
    else:
        jckpt.save(path, ref, 1, JGrid(W, H))
        got, step = ckpt.load(path, CoupledState, device="cpu")
        assert all(getattr(got, f).device == CPU for f in FIELDS)
        want = port
    assert step == 1
    _assert_states_equal(got, want)
    # the same keys and metadata whichever package wrote the file
    other = str(tmp_path / "other.npz")
    if writer == "port":
        jckpt.save(other, ref, 1, JGrid(W, H))
    else:
        ckpt.save(other, port, 1, TGrid(W, H))
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k,
                                          strict=True)


def test_resume_equals_uninterrupted_run(start, tmp_path):
    jcfg, cfg, arrays = start
    path = str(tmp_path / "run.ckpt.npz")
    straight = _steps(_port_state(arrays), 4, cfg)

    s = _steps(_port_state(arrays), 2, cfg)
    ckpt.save(path, s, 2, TGrid(W, H))
    saved = _numpy(s)
    del s  # the crash
    s2, step = ckpt.load(path, CoupledState, device="cpu")
    assert step == 2
    resumed = _steps(s2, 4 - step, cfg)
    _assert_states_equal(resumed, straight)

    # the reference resumes from the port's file as from its own state
    js, jstep_no = jckpt.load(path, JState)
    ja = JState(**{k: jnp.asarray(v) for k, v in saved.items()})
    for _ in range(jstep_no, 4):
        js = jstep(js, JGrid(W, H), jcfg)
        ja = jstep(ja, JGrid(W, H), jcfg)
    for name in ("height", "u", "v", "temperature", "t_index"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   np.asarray(getattr(ja, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_checkpoint_write_is_atomic(start, tmp_path):
    """A pre-existing checkpoint survives an interrupted overwrite."""
    _, _, arrays = start
    path = str(tmp_path / "run.ckpt.npz")
    ckpt.save(path, _port_state(arrays), 1, TGrid(W, H))
    before = os.stat(path).st_size

    class Boom(RuntimeError):
        pass

    class Exploding:
        """Array-like that fails mid-serialization."""
        shape = (4,)
        dtype = np.float32

        def __array__(self, *a, **k):
            raise Boom()

    bad = CoupledState(**{f: Exploding() for f in FIELDS})
    with pytest.raises(Boom):
        ckpt.save(path, bad, 2, TGrid(W, H))
    assert os.stat(path).st_size == before
    _, step = ckpt.load(path, CoupledState, device="cpu")
    assert step == 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_none_leaves_are_skipped(start, tmp_path):
    """A None leaf (the optional flow_acc) is not written; both packages
    load the file with the field at its default."""
    _, _, arrays = start
    state = dataclasses.replace(_port_state(arrays), flow_acc=None)
    path = str(tmp_path / "none.npz")
    ckpt.save(path, state, 0)
    with np.load(path) as z:
        assert "f_flow_acc" not in z.files
        assert "__coords__" not in z.files
        assert [str(s) for s in z["__fields__"]] == list(FIELDS[:-1])
    got, _ = ckpt.load(path, CoupledState, device="cpu")
    assert got.flow_acc is None
    jgot, _ = jckpt.load(path, JState)
    assert jgot.flow_acc is None
    d = str(tmp_path / "sharded")
    ckpt.save_sharded(d, state, 0)
    got, _ = ckpt.load_sharded(d, CoupledState, device="cpu")
    assert got.flow_acc is None
    np.testing.assert_array_equal(got.height.numpy(), arrays["height"])


def test_latest_and_foreign_files(start, tmp_path):
    _, _, arrays = start
    assert ckpt.latest(str(tmp_path / "missing.npz")) is None
    d = tmp_path / "dir"
    d.mkdir()
    assert ckpt.latest(str(d)) is None    # no manifest: incomplete
    ckpt.save_sharded(str(d), _port_state(arrays), 3, TGrid(W, H))
    assert ckpt.latest(str(d)) == str(d)
    f = tmp_path / "f.npz"
    ckpt.save(str(f), _port_state(arrays), 3)
    assert ckpt.latest(str(f)) == str(f)
    np.savez(tmp_path / "foreign.npz", __magic__=np.array("other"))
    with pytest.raises(ValueError, match="not a demiurge_tpu checkpoint"):
        ckpt.load(str(tmp_path / "foreign.npz"), CoupledState, device="cpu")


def test_sharded_directories_interchange_with_reference(start, tmp_path):
    """Without a mesh the port writes one shard of whole arrays; the
    reference's directory from a 2x4 mesh of 8 CPU devices (one file, 8
    blocks a field) assembles in the port; each reads the other's."""
    from demiurge_tpu.dist import field_sharding, make_mesh

    _, _, arrays = start
    state = _port_state(arrays)
    d = str(tmp_path / "port")
    ckpt.save_sharded(d, state, 5, TGrid(W, H))
    got, step = jckpt.load_sharded(d, JState)
    assert step == 5
    _assert_states_equal(got, state)

    s8 = field_sharding(make_mesh(8, shape=(2, 4)))
    sharded = JState(**{k: (jax.device_put(jnp.asarray(v), s8)
                            if v.ndim == 2 else jnp.asarray(v))
                        for k, v in arrays.items()})
    d = str(tmp_path / "reference")
    jckpt.save_sharded(d, sharded, 7, JGrid(W, H))
    with np.load(os.path.join(d, "shard_00000.npz")) as z:
        assert len([k for k in z.files if k.startswith("f_height__")]) == 8
    got, step = ckpt.load_sharded(d, CoupledState, device="cpu")
    assert step == 7
    _assert_states_equal(got, state)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_coupled_resume(tmp_path):
    """Through the CLI: run with --checkpoint, then --resume
    (tests/test_checkpoint.py:180-194); the resumed run ends where an
    uninterrupted one does, bit for bit, and --png writes the terrain."""
    path = str(tmp_path / "cli.ckpt.npz")
    common = ["coupled", "--device", "cpu", "--width", str(W), "--height",
              str(H), "--checkpoint", path, "--checkpoint-every", "1"]
    tcli.main(common + ["--steps", "2"])
    _, step = ckpt.load(path, CoupledState, device="cpu")
    assert step == 2
    resumed = tcli.main(common + ["--steps", "3", "--resume",
                                  "--png", str(tmp_path / "c.png")])
    got, step = ckpt.load(path, CoupledState, device="cpu")
    assert step == 3
    _assert_states_equal(got, resumed)
    straight = tcli.main(["coupled", "--device", "cpu", "--width", str(W),
                          "--height", str(H), "--steps", "3"])
    _assert_states_equal(resumed, straight)
    img = tpng.read_png(tmp_path / "c.png")
    assert img.shape == (H, W, 4)
    # --checkpoint-every past the run: only the final checkpoint
    tcli.main(["coupled", "--device", "cpu", "--width", str(W), "--height",
               str(H), "--steps", "1", "--checkpoint", str(tmp_path / "e"),
               "--checkpoint-every", "5"])
    assert ckpt.load(str(tmp_path / "e"), CoupledState, "cpu")[1] == 1


@pytest.mark.parametrize("cmd", ["ocean", "climate"])
def test_cli_png_matches_reference_cli(tmp_path, cmd):
    """The reference CLI's --save field, rendered by the port's CLI path,
    within 1 LSB of the reference CLI's --png."""
    steps = {"ocean": "0", "climate": "1"}[cmd]
    jcli.main([cmd, "--width", str(W), "--height", str(H), "--steps", steps,
               "--save", str(tmp_path / "j.npz"), "--png",
               str(tmp_path / "j.png")])
    field = np.load(tmp_path / "j.npz")["terrain"]
    args = types.SimpleNamespace(save=None, png=str(tmp_path / "t.png"))
    lay = types.SimpleNamespace(full=lambda x: x, lead=True,
                                close=lambda: None)
    logger = types.SimpleNamespace(close=lambda: None)
    tcli._finish(args, TGrid(W, H), torch.from_numpy(field), logger, lay)
    got = tpng.read_png(tmp_path / "t.png")
    want = tpng.read_png(tmp_path / "j.png")
    assert got.shape == want.shape == (H, W, 4)
    lsb = np.abs(np.round(got * 255) - np.round(want * 255))
    assert lsb.max() <= 1, int((lsb > 1).sum())


def test_multiprocess_tool_on_gloo():
    """tools/multiprocess_test.py's counterpart, two gloo processes."""
    run = subprocess.run(
        [sys.executable, "-m", "demiurge_tpu_torch.tools.multiprocess_test",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=pathlib.Path(__file__).resolve().parent.parent,
        env=_group_env())
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["process_count"] == 2
    assert result["backend"] == "gloo"
    assert result["resume_then_step_max_abs_height_diff"] == 0.0
    assert result["single_host_assembly_step"] == 3


# ---------------------------------------------------------------------------
# sharded checkpoints on gloo groups
# ---------------------------------------------------------------------------


def _group_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    return env


def _run_group(start, shape, tmp, elastic=None):
    jcfg, _, arrays = start
    ny, nx = shape
    meta = json.dumps({"shape": [W, H], "cfg": dataclasses.asdict(jcfg)})
    np.savez(tmp / "in.npz", meta=np.asarray(meta), **arrays)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / "in.npz"), str(tmp),
         str(ny), str(nx), str(r)] + ([str(elastic)] if elastic else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_group_env()) for r in range(ny * nx)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return dict(np.load(tmp / "out.npz")), tmp


@pytest.fixture(scope="module")
def groups(start, tmp_path_factory):
    """The 1x2 group, then the 2x1 group, which also resumes the 1x2
    group's checkpoint (elastic)."""
    a = _run_group(start, (1, 2), tmp_path_factory.mktemp("mesh1x2"))
    b = _run_group(start, (2, 1), tmp_path_factory.mktemp("mesh2x1"),
                   elastic=a[1] / "ckpt")
    return {(1, 2): a, (2, 1): b}


@pytest.fixture(scope="module")
def single(start):
    """Two and four single-device steps from the same initial state."""
    _, cfg, arrays = start
    s2 = _steps(_port_state(arrays), 2, cfg)
    return s2, _steps(s2, 2, cfg)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharded_files_hold_blocks(groups, shape):
    ny, nx = shape
    _, d = groups[shape]
    h, w = H // ny, W // nx
    for rank in range(ny * nx):
        yi, xi = divmod(rank, nx)
        with np.load(d / "ckpt" / f"shard_{rank:05d}.npz") as z:
            for name in FIELDS:
                if name == "t_index":
                    assert z["s_t_index"].shape == ()
                    continue
                assert z[f"f_{name}__0"].shape == (h, w)
                np.testing.assert_array_equal(
                    z[f"i_{name}__0"], [[yi * h, yi * h + h],
                                        [xi * w, xi * w + w]])
    with np.load(d / "ckpt" / "manifest.npz") as m:
        assert int(m["__nproc__"]) == ny * nx and int(m["__step__"]) == 2
        assert tuple(m["shape_height"]) == (H, W)
        assert str(m["dtype_height"]) == "float32"


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharded_resume_and_assembly_are_exact(groups, shape):
    out, d = groups[shape]
    for name in FIELDS:
        np.testing.assert_array_equal(out[f"loaded_{name}"],
                                      out[f"saved_{name}"], err_msg=name,
                                      strict=True)
        np.testing.assert_array_equal(out[f"resumed_{name}"],
                                      out[f"cont_{name}"], err_msg=name,
                                      strict=True)
    got, step = ckpt.load_sharded(str(d / "ckpt"), CoupledState,
                                  device="cpu")
    ref, jstep_no = jckpt.load_sharded(str(d / "ckpt"), JState)
    assert step == jstep_no == 2
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      out[f"saved_{name}"], err_msg=name,
                                      strict=True)
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      out[f"saved_{name}"], err_msg=name,
                                      strict=True)


@pytest.mark.parametrize("onto", ["one-process", "2x1"])
def test_elastic_resume_matches_single_device(start, groups, single, onto):
    _, cfg, _ = start
    _, four = single
    if onto == "one-process":
        got, step = ckpt.load_sharded(str(groups[(1, 2)][1] / "ckpt"),
                                      CoupledState, device="cpu")
        assert step == 2
        got = interop.coupled_state_to_numpy(_steps(got, 2, cfg))
    else:
        out = groups[(2, 1)][0]
        got = {name: out[f"elastic_{name}"] for name in FIELDS}
    for name in ("height", "u", "v", "temperature"):
        np.testing.assert_allclose(got[name], getattr(four, name).numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    assert float(got["t_index"]) == float(four.t_index) == 8.0


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_cli_mesh_checkpoint_resume(groups, shape, tmp_path):
    _, d = groups[shape]
    resumed, step = ckpt.load(str(d / "cli_resumed.npz"), CoupledState,
                              device="cpu")
    straight, step2 = ckpt.load(str(d / "cli_straight.npz"), CoupledState,
                                device="cpu")
    assert step == step2 == 3
    _assert_states_equal(resumed, straight)
    one = str(tmp_path / "one.npz")
    tcli.main(["coupled", "--device", "cpu", "--width", str(W), "--height",
               str(H), "--steps", "3", "--checkpoint", one])
    single_run, _ = ckpt.load(one, CoupledState, device="cpu")
    for name, (rtol, atol) in SHARDED_BOUNDS.items():
        np.testing.assert_allclose(getattr(resumed, name).numpy(),
                                   getattr(single_run, name).numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)

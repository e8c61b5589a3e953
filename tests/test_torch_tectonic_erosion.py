"""BASELINE config 2 on the port: ``coupled_tectonic_erosion`` and the
``tectonic-erosion`` CLI against the reference, whose tectonic uplift is
jitted.  Its compile takes about a minute here, so every jitted reference
call of the suite is in this file, on one 64x32 grid with the default
TectonicsConfig, and the module fixture runs them once.

Tolerances, and why:

- ``tectonic_uplift`` on the reference's input stacks: the uplift and the
  plate fields with at most 0.5% of their values beyond rtol/atol 1e-5
  (as tests/test_torch_tectonics.py, the count printed; the jitted
  reference also contracts multiply-adds into FMAs), the rotations within
  rtol 1e-5, atol 1e-6.
- The coupled loop (4 iterations, the uplift refreshed at 0 and 2) with the
  reference's uplift fields fed in: config 1's bound
  (tests/test_torch_erosion_loop.py), the height within 1e-6 of max.
- The same loop end to end on the port's own uplift: the pixels beyond
  1e-6 of max at most 2% of the grid, and every one of them within 2
  pixels of a pixel whose uplift differs (the flips above, carried by the
  erosion pass's 3x3 slope to its neighbours).
- ``tectonic-erosion --width 64 --height 32 --steps 3`` against the
  reference CLI with its terrain made op by op (as
  tests/test_torch_erosion_loop.py): the same bounds as the end-to-end
  loop, and each logged mass within 1e-4 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.api import cli as jcli
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import erosion as je
from demiurge_tpu.ops import tectonics as jt
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu_torch.api import cli as tcli
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.native import lakes as nlakes
from demiurge_tpu_torch.ops import erosion as te
from demiurge_tpu_torch.ops import tectonics as tt
from demiurge_tpu_torch.utils import interop

torch.set_num_threads(2)
CPU = torch.device("cpu")
W, H = 64, 32
ITERATIONS, EVERY = 4, 2
FLIPS = 0.005      # share of values beyond rtol/atol 1e-5 (one pass)
SPREAD = 0.02      # share of pixels beyond 1e-6 of max (end to end)
REACH = 2          # pixels from a differing uplift pixel


def _start():
    return np.array(fbm(JGrid(W, H), NoiseParams(
        mode="default", octaves=4, scale=2.0, min=-1.5, max=2.0, seed=5)))


def _stack_np(stack):
    return tuple(np.array(x) for x in (stack.fields, stack.rotations,
                                       stack.angvel))


@pytest.fixture(scope="module")
def ref():
    """The reference's coupled loop with lakes on and off, each jitted
    ``tectonic_uplift`` call recorded as numpy (stack in, stack out,
    uplift)."""
    real = jt.tectonic_uplift
    h0 = _start()
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for lakes in (True, False):
            calls = []

            def recording(stack, grid, cfg=jt.TectonicsConfig()):
                out = real(stack, grid, cfg)
                calls.append((_stack_np(stack), _stack_np(out[0]),
                              np.array(out[1])))
                return out

            mp.setattr(jt, "tectonic_uplift", recording)
            h = je.coupled_tectonic_erosion(
                jnp.asarray(h0), jnp.ones((H, W)), JGrid(W, H),
                je.ErosionConfig(lakes=lakes), iterations=ITERATIONS,
                tectonic_every=EVERY)
            runs[lakes] = (np.array(h), calls)
    return h0, runs


def _flips(name, got, want) -> np.ndarray:
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-5)
    print(f"{name}: {int(bad.sum())} of {bad.size} values beyond rtol/atol "
          f"1e-5 (max |diff| {float(np.abs(got - want).max()):.3g})")
    assert bad.mean() <= FLIPS, (name, int(bad.sum()))
    return bad


def test_tectonic_uplift_matches_jitted_reference(ref):
    _, runs = ref
    calls = runs[True][1]
    assert len(calls) == ITERATIONS // EVERY
    for k, (stack_in, stack_out, uplift) in enumerate(calls):
        stack = interop.plate_stack_from_numpy(*stack_in, CPU)
        new, got = tt.tectonic_uplift(stack, TGrid(W, H))
        assert got.dtype == torch.float32 and tuple(got.shape) == (H, W)
        _flips(f"call {k} uplift", got.numpy(), uplift)
        fields, rotations, angvel = interop.plate_stack_to_numpy(new)
        _flips(f"call {k} plate fields", fields, stack_out[0])
        np.testing.assert_allclose(rotations, stack_out[1], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(angvel, stack_out[2])
    assert float(np.max(calls[0][2])) > 0   # the plates collide


def _replaying(calls):
    """A stand-in for the port's tectonic_uplift that returns the
    reference's recorded outputs in order."""
    it = iter(calls)

    def replay(stack, grid, cfg=None):
        _, stack_out, uplift = next(it)
        return (interop.plate_stack_from_numpy(*stack_out, CPU),
                torch.from_numpy(uplift))
    return replay


def _port_loop(h0, lakes):
    return te.coupled_tectonic_erosion(
        torch.from_numpy(h0), torch.ones(H, W), TGrid(W, H),
        te.ErosionConfig(lakes=lakes), iterations=ITERATIONS,
        tectonic_every=EVERY).numpy()


@pytest.mark.parametrize("lakes", [True, False])
def test_coupled_with_reference_uplift(ref, lakes, monkeypatch):
    h0, runs = ref
    want, calls = runs[lakes]
    monkeypatch.setattr(tt, "tectonic_uplift", _replaying(calls))
    got = _port_loop(h0, lakes)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    assert np.abs(want - _start()).max() > 1e-3 * scale  # it moved


def _explained(name, got, want, uplift_bad):
    """The pixels beyond 1e-6 of max: at most SPREAD of the grid, each
    within REACH pixels of a differing uplift pixel."""
    diff = np.abs(got - want) > 1e-6 * np.abs(want).max()
    near = np.zeros_like(uplift_bad)
    for dy in range(-REACH, REACH + 1):
        for dx in range(-REACH, REACH + 1):
            near |= np.roll(np.roll(uplift_bad, dy, 0), dx, 1)
    print(f"{name}: {int(diff.sum())} of {diff.size} pixels beyond 1e-6 of "
          f"max; {int(uplift_bad.sum())} uplift pixels differ")
    assert diff.mean() <= SPREAD, int(diff.sum())
    assert not (diff & ~near).any(), np.argwhere(diff & ~near)


def _uplift_flips(calls):
    """Where the port's uplift differs from the reference's, over the
    loop's tectonic calls (each from the reference's input stack)."""
    bad = np.zeros((H, W), bool)
    for stack_in, _, uplift in calls:
        _, got = tt.tectonic_uplift(
            interop.plate_stack_from_numpy(*stack_in, CPU), TGrid(W, H))
        bad |= ~np.isclose(got.numpy(), uplift, rtol=1e-5, atol=1e-5)
    return bad


@pytest.mark.parametrize("lakes", [True, False])
def test_coupled_end_to_end(ref, lakes):
    h0, runs = ref
    want, calls = runs[lakes]
    _explained(f"lakes={lakes}", _port_loop(h0, lakes), want,
               _uplift_flips(calls))


def _eager_terrain(grid, seed):
    """The reference CLI's terrain, its fBm run op by op."""
    with jax.disable_jit():
        return jnp.asarray(np.asarray(fbm(grid, NoiseParams(
            octaves=8, scale=2.0, min=-4.0, max=6.0, seed=seed))))


def test_cli_tectonic_erosion_matches_reference_cli(ref, tmp_path,
                                                   monkeypatch):
    args = ["tectonic-erosion", "--width", str(W), "--height", str(H),
            "--steps", "3"]
    tlog, jlog = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    calls = nlakes.CALLS
    tcli.main(args + ["--device", "cpu", "--save", str(tmp_path / "t.npz"),
                      "--log", str(tlog)])
    assert nlakes.CALLS == calls + 3  # the native solver, once a step
    monkeypatch.setattr(jcli, "_terrain", _eager_terrain)
    recorded = []
    real = jt.tectonic_uplift

    def recording(stack, grid, cfg=jt.TectonicsConfig()):
        out = real(stack, grid, cfg)
        recorded.append((_stack_np(stack), None, np.array(out[1])))
        return out

    monkeypatch.setattr(jt, "tectonic_uplift", recording)
    jcli.main(args + ["--save", str(tmp_path / "j.npz"), "--log", str(jlog)])
    assert len(recorded) == 1    # step 0 (tectonic_every 5)
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["coords"], want["coords"])
    _explained("CLI", got["terrain"], want["terrain"],
               _uplift_flips(recorded))
    trecs = [json.loads(line) for line in tlog.read_text().splitlines()]
    jrecs = [json.loads(line) for line in jlog.read_text().splitlines()]
    assert [r["step"] for r in trecs] == [r["step"] for r in jrecs] \
        == [0, 1, 2]
    for t, j in zip(trecs, jrecs):
        assert t["mass"] == pytest.approx(j["mass"], rel=1e-4)


def test_interop_plate_stack_round_trip(ref):
    _, runs = ref
    stack_in = runs[True][1][1][0]
    stack = interop.plate_stack_from_numpy(*stack_in, CPU)
    assert tuple(stack.fields.shape) == (2, 4, H, W) and stack.n_plates == 2
    for got, want in zip(interop.plate_stack_to_numpy(stack), stack_in):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)

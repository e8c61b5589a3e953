"""The port's plate tectonics (ops/tectonics.py) against the reference,
run op by op (the jitted forms are held in
tests/test_torch_tectonic_erosion.py, from one fixture).

Tolerances, and why:

- ``init_plates``: exactly equal.
- Each pass (fold, ocean spreading, collision, unfold), on the
  reference's own inputs, so that flips do not compound: at most 0.5% of
  the values beyond rtol 1e-5, atol 1e-5 (the reference's own bound
  between its two forms, tests/test_tectonics_deterrace.py:109-113), and
  the count printed.  The passes fetch NEAREST at coordinates from atan2
  and asin, stretch taps by 1/cos and sum distances through asin and
  sqrt; torch's and XLA's functions differ by an ulp at a few percent of
  their inputs, which moves a fetch to its neighbour or flips a distance
  comparison.
- The same passes with XLA's sin, cos, asin, acos, atan2 and sqrt
  swapped into the port (tests/torch_xla_libm.py): bit for bit.  Where a
  tap's inputs equal the reference's, so does its output; what differs
  above is only the two libraries.
- Rotations: the host form (numpy, as the reference) exactly; the stacked
  form's (float32 on the device) within rtol 1e-5, atol 1e-6.
- ``tectonics_step`` over 2 steps, and the stacked step against the
  plate-list step: the 0.5% bound above.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import tectonics as jt
from demiurge_tpu.ops.noise import NoiseParams, fbm
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import tectonics as tt
from demiurge_tpu_torch.utils import interop
from torch_xla_libm import xla_libm

torch.set_num_threads(2)
CPU = torch.device("cpu")
W, H = 64, 32
FLIPS = 0.005   # the share of values allowed beyond rtol/atol 1e-5


def _terrain(W, H, seed=7):
    return np.array(fbm(JGrid(W, H), NoiseParams(
        octaves=4, scale=2.0, min=-2.0, max=3.0, seed=seed)))


def _last(t: torch.Tensor) -> np.ndarray:
    """(..., 4, H, W) -> the reference's (..., H, W, 4)."""
    return np.moveaxis(t.numpy(), -3, -1) if t.dim() >= 3 else t.numpy()


def _flips(name, got, want) -> int:
    """Print and return the count of values beyond rtol/atol 1e-5; fail
    above FLIPS of them."""
    want = np.asarray(want)
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-5)
    print(f"{name}: {int(bad.sum())} of {bad.size} values beyond rtol/atol "
          f"1e-5 (max |diff| {float(np.abs(got - want).max()):.3g})")
    assert bad.mean() <= FLIPS, (name, int(bad.sum()))
    return int(bad.sum())


def _port_plates(fields, rotations, angvels):
    return interop.plates_from_numpy(fields, rotations, angvels, CPU)


@pytest.fixture(scope="module")
def ref():
    """The reference's step 1 pass by pass, and 2 whole steps, at 64x32
    (op by op)."""
    g = JGrid(W, H)
    h0 = _terrain(W, H)
    plates = jt.init_plates(jnp.asarray(h0), g)
    init = [np.asarray(p.field) for p in plates]
    angvels = [p.angular_velocity.copy() for p in plates]
    for p in plates:
        p.rotate()
    rotations = [p.rotation.copy() for p in plates]
    world = jt.fold(plates, g)
    spread = jt.ocean_spreading(world, g)
    coll = jt.collision(spread, plates, g)
    unfolded = jt._unfold_impl(spread, [p.field for p in plates],
                               [jnp.asarray(r) for r in rotations], g)
    steps = []
    plates = jt.init_plates(jnp.asarray(h0), g)
    for _ in range(2):
        plates, terrain = jt.tectonics_step(plates, g)
        steps.append(([np.asarray(p.field) for p in plates],
                      [p.rotation.copy() for p in plates],
                      np.asarray(terrain)))
    return dict(h0=h0, init=init, angvels=angvels, rotations=rotations,
                world=np.asarray(world), spread=np.asarray(spread),
                coll=np.asarray(coll),
                unfolded=[np.asarray(f) for f in unfolded], steps=steps)


def test_init_plates_exactly(ref):
    plates = tt.init_plates(torch.from_numpy(ref["h0"]), TGrid(W, H))
    fields, rotations, angvels = interop.plates_to_numpy(plates)
    np.testing.assert_array_equal(fields, np.stack(ref["init"]))
    np.testing.assert_array_equal(rotations, np.stack([np.eye(3)] * 2))
    np.testing.assert_array_equal(angvels, np.stack(ref["angvels"]))
    assert angvels.dtype == rotations.dtype == np.float32


def _run_pass(name, ref):
    """The port's pass ``name`` on the reference's inputs, channels
    last."""
    tg = TGrid(W, H)
    plates = _port_plates(ref["init"], ref["rotations"], ref["angvels"])

    def world(key):
        return torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(ref[key], -1, 0)))

    if name == "fold":
        return [_last(tt.fold(plates, tg))], [ref["world"]]
    if name == "ocean_spreading":
        return [_last(tt.ocean_spreading(world("world"), tg))], \
            [ref["spread"]]
    if name == "collision":
        return [_last(tt.collision(world("spread"), plates, tg))], \
            [ref["coll"]]
    tt.unfold(world("spread"), plates, tg)
    return [_last(p.field) for p in plates], ref["unfolded"]


PASSES = ["fold", "ocean_spreading", "collision", "unfold"]


@pytest.mark.parametrize("name", PASSES)
def test_pass_matches_reference(name, ref):
    for got, want in zip(*_run_pass(name, ref)):
        _flips(name, got, want)


@pytest.mark.parametrize("name", PASSES)
def test_pass_equals_reference_with_its_libm(name, ref):
    with xla_libm(tt):
        for got, want in zip(*_run_pass(name, ref)):
            np.testing.assert_array_equal(got, want)


def test_rotations_match_reference(ref):
    plates = _port_plates(ref["init"], [np.eye(3, dtype=np.float32)] * 2,
                          ref["angvels"])
    for p in plates:
        p.rotate()
    for p, want in zip(plates, ref["rotations"]):
        assert p.rotation.dtype == np.float32
        np.testing.assert_array_equal(p.rotation, want)
    # the stacked form's rotation (float32 torch) against the reference's
    # jnp one and against the host form
    for w, want in zip(ref["angvels"], ref["rotations"]):
        got = tt._axis_angle_t(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, np.asarray(
            jt._axis_angle_jnp(jnp.asarray(w))), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tt._axis_angle_t(torch.zeros(3)).numpy(), np.eye(3))


def test_tectonics_step_two_steps(ref):
    tg = TGrid(W, H)
    plates = tt.init_plates(torch.from_numpy(ref["h0"]), tg)
    for k, (fields, rotations, terrain) in enumerate(ref["steps"]):
        plates, got = tt.tectonics_step(plates, tg)
        _flips(f"step {k + 1} terrain", got.numpy(), terrain)
        for p, f, r in zip(plates, fields, rotations):
            _flips(f"step {k + 1} plate field", _last(p.field), f)
            np.testing.assert_array_equal(p.rotation, r)


def test_stacked_matches_legacy(ref):
    """The stack's step against the plate list's (as the reference's own
    test_tectonics_stacked_matches_legacy) and against the reference."""
    tg = TGrid(W, H)
    h0 = torch.from_numpy(ref["h0"])
    plates = tt.init_plates(h0, tg)
    stack = tt.init_plate_stack(h0, tg)
    for k, (_, _, ref_terrain) in enumerate(ref["steps"]):
        plates, terr_l = tt.tectonics_step(plates, tg)
        stack, terr_s = tt.tectonics_step_stacked(stack, tg)
        _flips(f"step {k + 1} stacked terrain / plate list", terr_s.numpy(),
               terr_l.numpy())
        _flips(f"step {k + 1} stacked terrain / reference", terr_s.numpy(),
               ref_terrain)
        for i, p in enumerate(plates):
            _flips(f"step {k + 1} stacked field", stack.fields[i].numpy(),
                   p.field.numpy())
            np.testing.assert_allclose(stack.rotations[i].numpy(),
                                       p.rotation, rtol=1e-5, atol=1e-6)


# the reference's own tectonics tests (tests/test_tectonics_deterrace.py),
# on the port


def test_step_evolves():
    tg = TGrid(32, 16)
    plates = tt.init_plates(torch.from_numpy(_terrain(32, 16)), tg)
    ages0 = plates[0].field[1].numpy().copy()
    plates, terr = tt.tectonics_step(plates, tg)
    ages1 = plates[0].field[1].numpy()
    live = (ages0 >= 0) & (ages1 >= 0) & (ages1 < 2)
    aged = live & (np.abs(ages1 - ages0 - 0.01) < 1e-5)
    assert live.any() and aged.any()
    np.testing.assert_allclose(ages1[aged] - ages0[aged], 0.01, atol=1e-5)
    assert np.isfinite(terr.numpy()).all()


def test_index_mode_reference_output():
    """'index' mode writes the plate index map, as the reference does."""
    tg = TGrid(32, 16)
    _, terr = tt.run_tectonics(
        torch.from_numpy(_terrain(32, 16)), tg,
        tt.TectonicsConfig(steps=2, render_mode="index"))
    assert set(np.unique(terr.numpy()).tolist()) <= {0.0, 1.0, 2.0}


def test_divergence_creates_ridge_crust():
    """Plates pulling apart create new (height -index, age 1) crust along
    the divergent boundary; the terrain is all land, so only ridge
    creation writes height == -index."""
    tg = TGrid(64, 32)
    plates = tt.init_plates(torch.ones(32, 64), tg)
    plates[0].angular_velocity = 0.05 * np.array([-1.0, 0, 0], np.float32)
    plates[1].angular_velocity = -0.05 * np.array([-1.0, 0, 0], np.float32)
    for _ in range(4):
        plates, _ = tt.tectonics_step(plates, tg)
    new_crust = sum(int(((p.field[0] == -float(i)) & (p.field[1] >= 1.0))
                        .sum()) for i, p in enumerate(plates, start=1))
    assert new_crust > 0


def test_interop_plates_and_config_round_trip():
    rng = np.random.default_rng(0)
    fields = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    rotations = rng.standard_normal((2, 3, 3)).astype(np.float32)
    angvels = rng.standard_normal((2, 3)).astype(np.float32)
    plates = interop.plates_from_numpy(fields, rotations, angvels, CPU)
    assert tuple(plates[0].field.shape) == (4, 8, 16)
    for got, want in zip(interop.plates_to_numpy(plates),
                         (fields, rotations, angvels)):
        np.testing.assert_array_equal(got, want)
    cfg = interop.tectonics_config_from_dict(dataclasses.asdict(
        jt.TectonicsConfig(steps=3, render_mode="index")))
    assert isinstance(cfg, tt.TectonicsConfig) and cfg.steps == 3
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jt.TectonicsConfig(steps=3, render_mode="index"))
    with pytest.raises(ValueError):
        interop.tectonics_config_from_dict({"no_such_field": 1})

"""The port's simplex noise, seed offsets, fBm (all seven modes) and
gradient_noise against the reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demiurge_tpu_torch.core.grid as tgrid_module
from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import noise as jnoise
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import noise as tnoise
from torch_xla_libm import xla_libm

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 3, 7, 123])
def test_seed_offset_bit_exact(seed):
    want = np.asarray(jnoise.seed_offset_from(seed))
    got = tnoise.seed_offset_from(seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_snoise_grad_matches_reference():
    """Value and analytic gradient at random points, including the large
    coordinates the seed offsets produce; tolerance: f32 rounding of the
    few-term sums (values are O(1))."""
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-3, 3, (500, 3)),
                          rng.uniform(0, 20000, (500, 3))]).astype(np.float32)
    jv, jg = jnoise.snoise_grad(jnp.asarray(pts))
    tv, tg = tnoise.snoise_grad(torch.from_numpy(pts))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-4)


PARAMS = jnoise.NoiseParams(octaves=4, scale=2.0, min=-4.0, max=6.0, seed=7)
SPAN = PARAMS.max - PARAMS.min


def _both_fbm(how, jit):
    jg, tg = JGrid(128, 64), TGrid(128, 64)
    tparams = tnoise.NoiseParams(**dataclasses.asdict(PARAMS))
    off = None
    if how == "explicit_offset":
        off = np.random.default_rng(4).uniform(0, 10000, 3).astype(np.float32)
    joff = None if off is None else jnp.asarray(off)
    if jit:
        want = jnoise.fbm(jg, PARAMS, joff)
    else:
        with jax.disable_jit():
            want = jnoise.fbm(jg, PARAMS, joff)
    got = tnoise.fbm(tg, tparams, CPU, seed_offset=off)
    assert got.shape == (64, 128) and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("how", ["explicit_offset", "from_seed"])
def test_fbm_default_mode_matches_reference_op_by_op(how):
    """128x64, 4 octaves, against the reference evaluated op by op (the
    same f32 operations in the same order): within 1e-5 of the [min, max]
    range (in practice equal)."""
    got, want = _both_fbm(how, jit=False)
    np.testing.assert_allclose(got, want, atol=1e-5 * SPAN)


@pytest.mark.parametrize("how", ["explicit_offset", "from_seed"])
def test_fbm_default_mode_within_reference_jit_spread(how):
    """Against the jitted reference the port is held to the reference's own
    jit-vs-op-by-op spread: XLA's fusion rounds the sphere points and the
    octave sums differently, and the ~1e4 seed offsets amplify an ulp of the
    noise coordinate into ~1e-3 of the range at some pixels."""
    got, want_jit = _both_fbm(how, jit=True)
    _, want_eager = _both_fbm(how, jit=False)
    spread = np.abs(want_jit - want_eager).max()
    assert spread < 5e-3 * SPAN
    assert np.abs(got - want_jit).max() <= spread + 1e-5 * SPAN


def test_fbm_other_modes_not_ported():
    """Every mode of the reference is ported now; a mode it does not have
    raises, as the reference's does."""
    with pytest.raises(ValueError):
        tnoise.fbm(TGrid(16, 8), tnoise.NoiseParams(mode="voronoi"), CPU)
    with pytest.raises(ValueError):
        jnoise.fbm(JGrid(16, 8), jnoise.NoiseParams(mode="voronoi"))


MODES = ("default", "ridged", "billowy", "iq", "swiss", "jordan", "plateaus")


@pytest.fixture(scope="module")
def mode_refs():
    """Each mode at 64x32, 8 octaves, warp 0.5 (the warp rotates the
    sphere points, and swiss, jordan and plateaus rotate every octave),
    through the reference op by op."""
    grid = JGrid(64, 32)
    out = {}
    for mode in MODES:
        params = jnoise.NoiseParams(mode=mode, octaves=8, scale=1.5,
                                    min=-4.0, max=6.0, seed=7, warp=0.5)
        with jax.disable_jit():
            out[mode] = (params, np.asarray(jnoise.fbm(grid, params)))
    return out


def _port_mode(params):
    return tnoise.fbm(TGrid(64, 32),
                      tnoise.NoiseParams(**dataclasses.asdict(params)),
                      CPU).numpy()


@pytest.mark.parametrize("mode", MODES)
def test_fbm_modes_bit_for_bit_with_xla_libm(mode_refs, mode):
    """With XLA's sin, cos and sqrt swapped into the port
    (tests/torch_xla_libm.py), each mode equals the reference run op by
    op bit for bit: every other operation, the per-mode Python-float or
    per-pixel amplitudes, and the cross products (component differences
    rounded as written) are the reference's."""
    params, want = mode_refs[mode]
    with xla_libm(tnoise, tgrid_module):
        got = _port_mode(params)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_fbm_modes_against_reference_op_by_op(mode_refs, mode):
    """With torch's own sin, cos and sqrt: an ulp in a sphere point or a
    rotation, times the ~1e4 seed offset, moves a noise coordinate, so a
    few pixels differ.  Bounded: at most 3% of the pixels beyond 1e-5 of
    the [min, max] range (at most 36 of 2048 measured) and none beyond
    1e-3 of it (3e-4 measured)."""
    params, want = mode_refs[mode]
    got = _port_mode(params)
    span = params.max - params.min
    err = np.abs(got - want)
    share = float((err > 1e-5 * span).mean())
    print(f"{mode}: {share:.4f} of the pixels beyond 1e-5 of the range, "
          f"max {err.max() / span:.2e} of it")
    assert share <= 0.03
    assert err.max() <= 1e-3 * span


@pytest.mark.parametrize("blend_mode", ["replace", "add", "max"])
def test_gradient_noise_blends_through_selection(blend_mode):
    """``gradient_noise`` = the reference's: fBm blended into the terrain
    through the selection (op by op, bit for bit)."""
    rng = np.random.default_rng(1)
    h = rng.normal(size=(16, 32)).astype(np.float32)
    sel = rng.random((16, 32)).astype(np.float32)
    params = jnoise.NoiseParams(mode="billowy", octaves=3, seed=2)
    with jax.disable_jit():
        want = jnoise.gradient_noise(jnp.asarray(h), jnp.asarray(sel),
                                     JGrid(32, 16), params, blend_mode)
    got = tnoise.gradient_noise(
        torch.from_numpy(h), torch.from_numpy(sel), TGrid(32, 16),
        tnoise.NoiseParams(**dataclasses.asdict(params)), blend_mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

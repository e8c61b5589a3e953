"""The port's simplex noise, seed offsets and fBm against the reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import noise as jnoise
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.ops import noise as tnoise

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
    with pytest.raises(NotImplementedError):
        tnoise.fbm(TGrid(16, 8), tnoise.NoiseParams(mode="ridged"), CPU)

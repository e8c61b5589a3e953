"""The port's tap sampler (kernels/advect.py) against the reference.

The plain twin runs here against the Pallas kernels in interpret mode and
the XLA tap loop; the CUDA kernel is held to the twin on the card in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import ocean as jocean
from demiurge_tpu.pallas_kernels import advect as jadvect
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import advect as ka

torch.set_num_threads(2)


def _fields(W, H, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((H, W)).astype(np.float32)
    v = rng.standard_normal((H, W)).astype(np.float32)
    return u, v


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _meta_reference(radii, W):
    """The table as demiurge_tpu/pallas_kernels/advect.py:259-265 builds it
    inside advect_sample_tiered (it is not exposed there)."""
    Rf, stride = 6, 8
    meta = np.zeros((len(radii), 2), np.int32)
    for i, r in enumerate(radii):
        if r > 16:
            meta[i] = (r, min((r + stride - 1) // stride, W // 16))
        else:
            meta[i] = (r, 0)
    return meta


@pytest.mark.parametrize("W,H,vmax", [(256, 128, 5.0), (2048, 1024, 0.8),
                                      (512, 256, 1.0), (128, 64, 40.0)])
def test_strip_radii_and_meta_match_reference(W, H, vmax):
    jr = jadvect.strip_radii(JGrid(W, H), vmax, 24.0)
    tr = ka.strip_radii(TGrid(W, H), vmax, 24.0)
    assert tr == jr
    np.testing.assert_array_equal(ka.strip_meta(tr, W),
                                  _meta_reference(jr, W))


def test_tiered_plain_matches_pallas_kernel_with_polar_strips():
    """256x128 at vmax=5: the outer strips are polar (rx=256, q capped at
    W//16 = 16, so the coarse lattice wraps the whole ring), the inner ones
    exact; dx spans each strip's full clamp range.  Within atol 1e-6 of
    the interpret-mode _kernel_dyn (same taps, same order)."""
    W, H, vmax, Ry = 256, 128, 5.0, 2
    u, v = _fields(W, H)
    radii = ka.strip_radii(TGrid(W, H), vmax, 24.0)
    assert max(radii) == 256 and min(radii) <= 16
    rng = np.random.default_rng(3)
    rxrow = np.repeat(np.asarray(radii, np.float32), ka.STRIP)[:, None]
    dx = (rng.uniform(-1, 1, (H, W)) * rxrow).astype(np.float32)
    dx[:, :16] = rng.uniform(-6, 6, (H, 16))   # polar fine taps too
    dy = rng.uniform(-Ry, Ry, (H, W)).astype(np.float32)
    ju, jv = jadvect.advect_sample_tiered(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(dx), jnp.asarray(dy),
        JGrid(W, H), vmax=vmax, timestep=24.0, Ry=Ry, interpret=True)
    tu, tv = ka.advect_sample_tiered_plain(
        _t(u), _t(v), _t(dx), _t(dy), ka.strip_meta(radii, W), ka.STRIP, Ry)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_global_radius_form_matches_xla_taps_and_pallas_kernel():
    """The one-row table (rx=8, q=0 on every row) against the XLA tap loop
    of ops.ocean._advect_sample_fast (atol 1e-5, as the reference holds its
    own kernel) and the interpret-mode advect_sample_pallas."""
    W, H, Rx, Ry = 256, 128, 8, 2
    u, v = _fields(W, H, seed=1)
    rng = np.random.default_rng(7)
    dx = rng.uniform(-Rx, Rx, (H, W)).astype(np.float32)
    dy = rng.uniform(-Ry, Ry, (H, W)).astype(np.float32)
    c = np.arange(W, dtype=np.float32)[None, :]
    r = np.arange(H, dtype=np.float32)[:, None]
    s2 = (c + dx + 0.5) / W
    t2 = (r + dy + 0.5) / H
    xu, xv = jocean._advect_sample_fast(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(s2), jnp.asarray(t2),
        JGrid(W, H), Rx, Ry)
    pu, pv = jadvect.advect_sample_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(dx), jnp.asarray(dy),
        Rx, Ry, interpret=True)
    # the XLA loop re-derives (dx, dy) from (s2, t2); feed the port the
    # same, and the raw (dx, dy) where the Pallas kernel gets them
    cdx = np.clip(s2 * W - 0.5 - c, -Rx, Rx)
    cdy = np.clip(t2 * H - 0.5 - r, -Ry, Ry)
    meta = ka.global_meta(Rx)
    tu, tv = ka.advect_sample_tiered_plain(_t(u), _t(v), _t(cdx), _t(cdy),
                                           meta, H, Ry)
    ru, rv = ka.advect_sample_tiered_plain(_t(u), _t(v), _t(dx), _t(dy),
                                           meta, H, Ry)
    for got, want in ((tu, xu), (tv, xv), (ru, pu), (rv, pv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_meta_must_cover_the_rows():
    u = torch.zeros(64, 32)
    with pytest.raises(ValueError):
        ka.advect_sample_tiered_plain(u, u, u, u, ka.global_meta(2), 32, 1)

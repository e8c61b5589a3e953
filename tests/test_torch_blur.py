"""The port's spherical blur against the reference.

The same fBm-like field goes through the JAX package on the CPU (the XLA
fast path of ``ops.blur``, and the Pallas pre-blur kernel in interpret
mode) and through the port on the CPU (the kernel's plain twin, the
``blur13_pass`` sequence).  Tolerances, and why:

- ``sigma_list``: the same double arithmetic; exact.
- a pass, and the whole blur, against the XLA path run op by op: the same
  taps, weights and sum order; 2e-7 of the field's max (an ulp: compiled
  whole, XLA on the CPU also contracts the tap lerps and the weighted
  accumulation into fused multiply-adds, which moves the result by that
  much).
- against the Pallas kernel: it collapses the vertical taps to
  a*f + b*(up + dn) and reorders the sums; the reference's own bound
  (rtol 1e-5, atol 1e-6, tests/test_pallas.py).

The kernel's tables are held to the plain twin here too: a numpy
transliteration of ``csrc/blur.cu`` on ``kernels.blur.tables`` must give
the twin's result bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demiurge_tpu.core.grid import Grid as JGrid
from demiurge_tpu.ops import blur as jb
from demiurge_tpu.pallas_kernels.blur import blur_pallas
from demiurge_tpu_torch.core.grid import Grid as TGrid
from demiurge_tpu_torch.kernels import blur as kb
from demiurge_tpu_torch.ops import blur as tb

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _field(W, H, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(2):
        f = (f + np.roll(f, 1, 0) + np.roll(f, 1, 1)) / 3
    return (f * 3).astype(np.float32)


def _close(got, want, atol):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=atol)


@pytest.mark.parametrize("radius", [0.0, 0.5, 1.0, 3.0, 12.0])
def test_sigma_list_exact(radius):
    assert tb.sigma_list(radius) == jb.sigma_list(radius)


def test_pre_blur_iterations():
    """The pre-blur (radius 0.5) runs 5 iterations, every tap offset under
    one pixel."""
    rlist = tb.sigma_list(0.5)
    assert len(rlist) == 5
    assert max(rlist) * tb._OFFSETS[-1] < 1.0


@pytest.mark.parametrize("direction", [(0.0, 0.4), (0.4, 0.0), (0.0, 2.5)])
def test_blur13_pass_matches_xla(direction):
    f = _field(128, 64)
    want = jb.blur13_pass(jnp.asarray(f), JGrid(128, 64), direction)
    got = tb.blur13_pass(torch.from_numpy(f), TGrid(128, 64), direction)
    _close(got, want, 2e-7)


def test_blur_matches_reference():
    """``ops.blur.blur`` run op by op (compiling it whole costs the CPU
    half a minute)."""
    f = _field(128, 64, seed=1)
    with jax.disable_jit():
        want = jb.blur(jnp.asarray(f), JGrid(128, 64), 0.5)
    got = tb.blur(torch.from_numpy(f), TGrid(128, 64), 0.5)
    _close(got, want, 2e-7)


def test_blur_matches_pallas_interpret():
    f = _field(256, 128, seed=2)
    want = blur_pallas(jnp.asarray(f), JGrid(256, 128), 0.5, interpret=True)
    got = tb.blur(torch.from_numpy(f), TGrid(256, 128), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _kernel_in_numpy(f, grid, rlist):
    """csrc/blur.cu, transliterated: the same tables, the same order, each
    operation rounded to float32."""
    vk, vw, hk, hw, wt = (t.numpy() for t in kb.tables(grid, rlist, CPU))
    H, W = f.shape
    half = W // 2
    rows = np.arange(H)
    cols = np.arange(W)

    def row_of(k):
        rr = rows + k
        cc = np.broadcast_to(cols, (H, W))
        out_r = np.clip(rr, 0, H - 1)
        north = (rr >= H) & (k < H)
        south = (rr < 0) & (-k < H)
        out_r = np.where(north, 2 * H - 1 - rr, np.where(south, -rr - 1,
                                                          out_r))
        shift = (north | south)[:, None]
        return out_r[:, None], np.where(shift, (cc + half) % W, cc)

    for it in range(len(rlist)):
        acc = f * wt[0]
        for t in range(6):
            k = int(vk[it, t])
            v0, v1 = vw[it, t]
            r0, c0 = row_of(k)
            tap = f[r0, c0] * v0
            if v1 != 0:
                r1, c1 = row_of(k + 1)
                tap = tap + f[r1, c1] * v1
            acc = acc + tap * wt[1 + t // 2]
        f = acc
        acc = f * wt[0]
        for t in range(6):
            c0 = (cols[None, :] + hk[it, t][:, None]) % W
            c1 = (c0 + 1) % W
            tap = (np.take_along_axis(f, c0, 1) * hw[it, t, 0][:, None]
                   + np.take_along_axis(f, c1, 1) * hw[it, t, 1][:, None])
            acc = acc + tap * wt[1 + t // 2]
        f = acc
    return f


@pytest.mark.parametrize("radius", [0.5, 3.0])
def test_kernel_tables_reproduce_plain_twin(radius):
    grid = TGrid(128, 64)
    f = _field(128, 64, seed=3)
    rlist = tb.sigma_list(radius)
    want = kb.blur_plain(torch.from_numpy(f), grid, rlist).numpy()
    np.testing.assert_array_equal(_kernel_in_numpy(f, grid, rlist), want)


def test_regional_grid_raises():
    """Ported since (the name is kept from when the port raised here): a
    regional grid takes the GL-clamp gather path on the plain twin, never
    the kernel, so a constant field stays constant and nothing launches
    (tests/test_torch_core_samplers.py holds it to the reference)."""
    launches = kb.LAUNCHES
    out = tb.blur(torch.full((32, 64), 2.5),
                  TGrid(64, 32, (-1.0, 1.0, -2.0, 2.0)), 0.5)
    np.testing.assert_allclose(out.numpy(), 2.5, rtol=1e-6)
    assert kb.LAUNCHES == launches

"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports torch, numpy and the port only, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel evaluates the same sum in the same order as its twin, so the
tolerances are a few ulps of the field's max (in practice the results are
equal).
"""

import math

import numpy as np
import pytest
import torch

from demiurge_tpu_torch.core.grid import Grid
from demiurge_tpu_torch.kernels import advect as ka
from demiurge_tpu_torch.kernels import jacobi as kj
from demiurge_tpu_torch.ops import ocean

PI = math.pi
GLOBAL = (-PI / 2, PI / 2, -PI, PI)
REGIONAL = (-1.0, 0.9, -2.5, 1.0)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(W, H, coords, dev, seed=0):
    """A smooth land mask with real coastlines and random (u, v)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((H, W)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5
    u, v = (rng.standard_normal((2, H, W)) * 0.1).astype(np.float32)
    return Grid(W, H, coords), *(torch.from_numpy(a).to(dev)
                                 for a in (h, u, v))


def _rel_err(got, want):
    return float((got - want).abs().max()) / (float(want.abs().max())
                                              + 1e-30)


@pytest.mark.parametrize("coords", [GLOBAL, REGIONAL],
                         ids=["global", "regional"])
def test_pressure_kernel_equals_plain_twin(dev, coords):
    grid, h, u, v = _case(256, 128, coords, dev)
    div = ocean.divergence(u, v, h, grid, ocean.OceanConfig())
    coeffs = kj.coefficients(div, h, grid)
    p0 = torch.zeros_like(div)
    for iters in (0, 1, 2, 41):
        before = kj.PRESSURE_LAUNCHES
        got = kj.pressure_solve_cuda(*coeffs, p0, grid, iters)
        want = kj.pressure_solve_plain(*coeffs, p0, grid, iters)
        torch.cuda.synchronize()
        assert kj.PRESSURE_LAUNCHES - before == iters
        assert _rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("coords", [GLOBAL, REGIONAL],
                         ids=["global", "regional"])
def test_diffusion_kernel_equals_plain_twin(dev, coords):
    grid, h, u, v = _case(256, 128, coords, dev)
    coeffs = kj.diffusion_coefficients(h, grid)
    for iters in (1, 50, 51):
        gu, gv = kj.diffusion_solve_cuda(*coeffs, u, v, grid, iters)
        wu, wv = kj.diffusion_solve_plain(*coeffs, u, v, grid, iters)
        torch.cuda.synchronize()
        assert _rel_err(gu, wu) <= 1e-6 and _rel_err(gv, wv) <= 1e-6


@pytest.mark.parametrize("form", ["tiered", "global"])
def test_advect_kernel_equals_plain_twin(dev, form):
    """Polar strips included (vmax=5 at 256x128 gives rx=256, q=16), and
    displacements beyond the clamp and on integer taps."""
    W, H, Ry = 256, 128, 2
    grid, _, u, v = _case(W, H, GLOBAL, dev)
    rng = np.random.default_rng(3)
    if form == "tiered":
        radii = ka.strip_radii(grid, 5.0, 24.0)
        meta, rows = ka.strip_meta(radii, W), ka.STRIP
        lim = np.repeat(np.asarray(radii, np.float32), ka.STRIP)[:, None]
    else:
        meta, rows, lim = ka.global_meta(8), H, np.float32(8.0)
    dx = (rng.uniform(-1.2, 1.2, (H, W)) * lim).astype(np.float32)
    dx[:, :8] = rng.integers(-8, 9, (H, 8))
    dy = rng.uniform(-Ry - 0.5, Ry + 0.5, (H, W)).astype(np.float32)
    dx, dy = (torch.from_numpy(a).to(dev) for a in (dx, dy))
    before = ka.LAUNCHES
    gu, gv = ka.advect_sample_cuda(u, v, dx, dy, meta, rows, Ry)
    wu, wv = ka.advect_sample_tiered_plain(u, v, dx, dy, meta, rows, Ry)
    torch.cuda.synchronize()
    assert ka.LAUNCHES - before == 1
    assert float((gu - wu).abs().max()) <= 1e-6
    assert float((gv - wv).abs().max()) <= 1e-6


def test_ocean_step_on_the_card_matches_the_cpu(dev):
    """Three steps at 256x128 on the card (tiered advect, Jacobi kernels)
    against the CPU (single-radius advect, plain twins): the two advect
    forms agree wherever no pixel is clamped, which holds at these
    speeds; the rest is f32 rounding of the card's libm."""
    grid, h, _, _ = _case(256, 128, GLOBAL, dev)
    h = (h - 0.1) * 20
    cfg = ocean.OceanConfig(jacobi_iters=40, diffusion_iters=50)
    fields = {}
    for where in (dev, torch.device("cpu")):
        u, v = ocean.init_ocean(grid, where)
        hh = h.to(where)
        for _ in range(3):
            u, v, p, _ = ocean.ocean_step(u, v, hh, grid, cfg)
        fields[where.type] = (u.cpu(), v.cpu(), p.cpu())
    for got, want in zip(fields["cuda"], fields["cpu"]):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= 1e-4


def test_wrappers_reject_bad_inputs(dev):
    grid = Grid(64, 32)
    z = torch.zeros(grid.shape, device=dev)
    with pytest.raises(ValueError, match="float32"):
        kj.pressure_solve_cuda(z, z, z, z, z, z, z.double(), grid, 2)
    with pytest.raises(ValueError, match="shape"):
        kj.diffusion_solve_cuda(z, z, z, z, z, z[:16], z[:16], grid, 2)
    with pytest.raises(ValueError, match="contiguous"):
        zt = torch.zeros(64, 32, device=dev).t()
        ka.advect_sample_cuda(zt, zt, zt, zt, ka.global_meta(8), 32, 2)
    with pytest.raises(ValueError, match="cover"):
        ka.advect_sample_cuda(z, z, z, z, ka.global_meta(8), 16, 2)

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


# ---------------------------------------------------------------------------
# the coupled step's kernels: climate, blur, directions, flow fixpoint
# ---------------------------------------------------------------------------


def _terrain(W, H, dev, seed=0):
    """A smooth random terrain with land, ocean and coastlines."""
    grid, h, _, _ = _case(W, H, GLOBAL, dev, seed)
    return grid, (h - 0.05) * 20


@pytest.mark.parametrize("shape", [(256, 128), (200, 100)],
                         ids=["256x128", "200x100"])
def test_climate_kernel_equals_plain_twin(dev, shape):
    from demiurge_tpu_torch.kernels import climate as kc
    from demiurge_tpu_torch.ops import temperature

    grid, h = _terrain(*shape, dev)
    T = temperature.init_temperature(grid, dev) + h
    i0 = torch.full((), 3.0, device=dev)
    asr = temperature.insolation_table(grid, i0, 10, 0.30)
    cinv = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
            / temperature.heat_capacity(h)).contiguous()
    before = kc.LAUNCHES
    got = kc.climate_step_cuda(T, cinv, asr, grid, 0.55e6)
    want = kc.climate_step_plain(T, cinv, asr, grid, 0.55e6)
    torch.cuda.synchronize()
    assert kc.LAUNCHES - before == 10
    assert torch.equal(got, want)


@pytest.mark.parametrize("radius", [0.5, 3.0])
def test_blur_kernel_equals_plain_twin(dev, radius):
    """Radius 0.5 is the pre-blur; 3.0 has taps several rows away, across
    the poles."""
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.ops.blur import sigma_list

    grid, h = _terrain(256, 128, dev)
    rlist = sigma_list(radius)
    before = kb.LAUNCHES
    got = kb.blur_cuda(h, grid, rlist)
    want = kb.blur_plain(h, grid, rlist)
    torch.cuda.synchronize()
    assert kb.LAUNCHES - before == 2 * len(rlist)
    assert torch.equal(got, want)


def test_directions_kernel_against_plain_twin(dev):
    """Equal but for knife-edge ties (atan2f of two builds): at most one in
    10^4 pixels."""
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.ops.blur import blur

    grid, h = _terrain(256, 128, dev)
    hb = blur(h, grid, 0.5)
    sel = torch.ones_like(hb)
    sel[:, :16] = 0.0
    before = kd.LAUNCHES
    got = kd.flow_directions_cuda(hb, sel, grid)
    want = kd.flow_directions_plain(hb, sel, grid)
    torch.cuda.synchronize()
    assert kd.LAUNCHES - before == 1
    assert got.dtype == torch.int32
    assert int((got != want).sum()) <= hb.numel() // 10000


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_flow_kernels_equal_plain_twins(dev, warm):
    """A bit for bit and vis exactly, cold and from a warm start (the
    fixpoint of a slightly different terrain)."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.ops import flow

    grid, h = _terrain(256, 128, dev)
    sel = torch.ones_like(h)
    area = flow.cell_area_lower_edge(grid, dev)

    def packed_of(height):
        hb = flow.blur(height, grid, 0.5)
        code = flow.flow_directions(hb, sel, grid)
        _, mouth, _ = flow.incoming_mask(code, grid)
        return kf.pack_masks(code, mouth, grid)

    a0 = None
    if warm:
        a0 = kf.flow_solve_area_plain(packed_of(h * 1.01 + 0.01), area, grid)
    packed = packed_of(h)
    before = (kf.LAUNCHES_A, kf.LAUNCHES_VIS)
    A = kf.flow_solve_area_cuda(packed, area, grid, a0)
    vis = kf.vis_solve_cuda(packed, grid)
    torch.cuda.synchronize()
    assert kf.LAUNCHES_A > before[0] and kf.LAUNCHES_VIS > before[1]
    assert torch.equal(A, kf.flow_solve_area_plain(packed, area, grid, a0))
    assert torch.equal(vis, kf.vis_solve_plain(packed, grid))
    assert bool(vis.any()) and float(A.max()) > float(area.max())


def test_coupled_step_on_the_card_matches_the_cpu(dev):
    """Three coupled steps at 256x128 on the card against the CPU: u, v
    and T as the ocean test allows; the height wherever the direction
    codes agree."""
    from demiurge_tpu_torch.model import CoupledConfig, coupled_step, \
        init_coupled

    grid, h = _terrain(256, 128, dev)
    cfg = CoupledConfig(climate_substeps=4,
                        ocean=ocean.OceanConfig(jacobi_iters=40,
                                                diffusion_iters=10))
    states = {}
    for where in (dev, torch.device("cpu")):
        s = init_coupled(h.to(where), grid)
        for _ in range(3):
            s = coupled_step(s, grid, cfg)
        states[where.type] = s
    g, c = states["cuda"], states["cpu"]
    for name in ("u", "v", "temperature", "height"):
        got = getattr(g, name).cpu()
        assert bool(torch.isfinite(got).all())
        if name != "height":
            assert _rel_err(got, getattr(c, name)) <= 1e-4
    dh = (g.height.cpu() - c.height).abs() / c.height.abs().max()
    assert float((dh > 1e-4).float().mean()) <= 1e-2


# ---------------------------------------------------------------------------
# the two-level flow solve's band-local kernels (K10)
# ---------------------------------------------------------------------------


def _flow_inputs(W, H, dev):
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.ops import flow

    grid, h = _terrain(W, H, dev)
    hb = flow.blur(h, grid, 0.5)
    code = flow.flow_directions(hb, torch.ones_like(hb), grid)
    _, mouth, _ = flow.incoming_mask(code, grid)
    area = flow.cell_area_lower_edge(grid, dev)
    return grid, code, mouth, area, kf.pack_masks(code, mouth, grid)


@pytest.mark.parametrize("band", [16, 32])
def test_local_flow_kernels_equal_plain_twins(dev, band):
    """K10a's A and exit ids bit for bit, cold and from a warm start, and
    K10b's vis exactly with an all-zero and a nonzero seed."""
    from demiurge_tpu_torch.kernels import flow2 as k2

    grid, _, _, area, packed = _flow_inputs(256, 128, dev)
    ploc = k2.mask_local(packed, band)
    before = (k2.LAUNCHES_LOCAL, k2.LAUNCHES_LOCAL_VIS)
    A, E = k2.flow_local_solve_cuda(ploc, area, area, band)
    wA, wE = k2.flow_local_solve_plain(ploc, area, area, band)
    torch.cuda.synchronize()
    assert torch.equal(A, wA) and torch.equal(E, wE)
    assert bool((E >= 0).any()) and float(A.max()) > 10 * float(area.max())
    warm = torch.rand(grid.shape, device=dev) * 2 * area
    A2, E2 = k2.flow_local_solve_cuda(ploc, area, warm, band, with_exit=False)
    assert E2 is None and torch.equal(A2, wA)
    seed = torch.zeros(grid.shape, device=dev)
    seed[band - 1, ::7] = 1.0
    seed[band, 3::11] = 1.0
    for s in (torch.zeros_like(seed), seed):
        got = k2.flow_local_vis_cuda(ploc, s, band)
        want = k2.flow_local_vis_plain(ploc, s, band)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert k2.LAUNCHES_LOCAL > before[0] and k2.LAUNCHES_LOCAL_VIS > before[1]


def test_twolevel_on_the_card_matches_k7(dev):
    """flow_solve_twolevel (K10a, the coarse graph, atomic scatter-adds)
    against K7's A at the reference's bound, rtol 1e-5, atol 1e-7."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow2 as k2

    grid, code, mouth, area, packed = _flow_inputs(256, 128, dev)
    want = kf.flow_solve_area_cuda(packed, area, grid)
    for band in (16, 32, 64):
        got = k2.flow_solve_twolevel(code, area, mouth, grid, band=band)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)

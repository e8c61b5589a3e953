"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports torch, numpy and the port only, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel evaluates the same sum in the same order as its twin, so most
are held to it bit for bit; the tolerances elsewhere are a few ulps of
the field's max or the reference's own bounds.
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


# the tiled Jacobi kernels' grids (tests/test_torch_jacobi_tiles.py runs
# their schedule on the CPU): the golden size, a width below a tile and its
# halo, an odd width, H < 2k, one pole only, and the coupled model's size
JACOBI_GRIDS = {
    "global": (256, 128, GLOBAL),
    "regional": (256, 128, REGIONAL),
    "128x64": (128, 64, GLOBAL),
    "96x48": (96, 48, GLOBAL),
    "255x128": (255, 128, GLOBAL),
    "64x12": (64, 12, GLOBAL),
    "40x24-south-cap": (40, 24, (-PI / 2, 0.5, -PI, PI)),
    "2048x1024": (2048, 1024, GLOBAL),
}


def _jacobi_iters(name, depth):
    """The coupled model's depth at its size; elsewhere every remainder
    case and a few launches more."""
    k = kj.SWEEPS_PER_LAUNCH
    if name == "2048x1024":
        return (depth,)
    return (0, 1, k - 1, k, k + 1, 41, depth, depth + 1)


@pytest.mark.parametrize("name", list(JACOBI_GRIDS))
def test_pressure_kernel_equals_plain_twin(dev, name):
    """Bit for bit, in ceil(iters / k) launches."""
    grid, h, u, v = _case(*JACOBI_GRIDS[name], dev)
    div = ocean.divergence(u, v, h, grid, ocean.OceanConfig())
    coeffs = kj.coefficients(div, h, grid)
    p0 = torch.zeros_like(div)
    for iters in _jacobi_iters(name, 200):
        before = kj.PRESSURE_LAUNCHES
        got = kj.pressure_solve_cuda(*coeffs, p0, grid, iters)
        want = kj.pressure_solve_plain(*coeffs, p0, grid, iters)
        torch.cuda.synchronize()
        assert kj.PRESSURE_LAUNCHES - before == math.ceil(
            iters / kj.SWEEPS_PER_LAUNCH)
        assert torch.equal(got, want), iters


@pytest.mark.parametrize("name", list(JACOBI_GRIDS))
def test_diffusion_kernel_equals_plain_twin(dev, name):
    """Bit for bit on (u, v), in ceil(iters / k) launches."""
    grid, h, u, v = _case(*JACOBI_GRIDS[name], dev)
    coeffs = kj.diffusion_coefficients(h, grid)
    for iters in _jacobi_iters(name, 50):
        before = kj.DIFFUSION_LAUNCHES
        gu, gv = kj.diffusion_solve_cuda(*coeffs, u, v, grid, iters)
        wu, wv = kj.diffusion_solve_plain(*coeffs, u, v, grid, iters)
        torch.cuda.synchronize()
        assert kj.DIFFUSION_LAUNCHES - before == math.ceil(
            iters / kj.SWEEPS_PER_LAUNCH)
        assert torch.equal(gu, wu) and torch.equal(gv, wv), iters


def test_jacobi_kernels_raise_on_a_refused_launch(dev, monkeypatch):
    """Sweeps a launch or a tile that csrc/jacobi.cu was not built for are
    refused by its entry points, and the wrappers raise; nothing is
    counted."""
    grid, h, u, v = _case(256, 128, GLOBAL, dev)
    coeffs = kj.coefficients(u, h, grid)
    dco = kj.diffusion_coefficients(h, grid)
    before = (kj.PRESSURE_LAUNCHES, kj.DIFFUSION_LAUNCHES)
    with monkeypatch.context() as m:
        m.setattr(kj, "SWEEPS_PER_LAUNCH", kj.SWEEPS_PER_LAUNCH + 1)
        with pytest.raises(RuntimeError, match="CUDA error"):
            kj.pressure_solve_cuda(*coeffs, u, grid, 20)
        with pytest.raises(RuntimeError, match="CUDA error"):
            kj.diffusion_solve_cuda(*dco, u, v, grid, 20)
    monkeypatch.setattr(kj, "PRESSURE_TILE", (48, 128))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kj.pressure_solve_cuda(*coeffs, u, grid, 20)
    assert (kj.PRESSURE_LAUNCHES, kj.DIFFUSION_LAUNCHES) == before


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


def _stage_case(W, H, dev, quirks):
    """A terrain with coastlines and (u, v) fast enough that the clamps
    bite (dx beyond the strips' rx, dy beyond Ry) and the polar strips
    take coarse taps (vmax 5 gives rx 256, q = W // 16 there)."""
    grid, h, u, v = _case(W, H, GLOBAL, dev, seed=4)
    cfg = ocean.OceanConfig(vmax_hint=5.0, exact_quirks=quirks)
    return grid, (h - 0.05) * 20, u * 80, v * 80, cfg


@pytest.mark.parametrize("quirks", [False, True],
                         ids=["coriolis", "exact_quirks"])
@pytest.mark.parametrize("shape", [(256, 128), (256, 120)],
                         ids=["tiered", "one-row"])
def test_advect_stage_kernel_equals_twin(dev, shape, quirks, monkeypatch):
    """The fused advect stage against its twin on the card, bit for bit,
    NaN-free; one launch, on the tiered table at H = 128 and the one-row
    table at H = 120.  The twin takes the plain tap sum in place of the
    sampler kernel, so the two share no kernel code."""
    grid, h, u, v, cfg = _stage_case(*shape, dev, quirks)
    before = (ka.LAUNCHES_STAGE, ka.LAUNCHES_ONE_ROW,
              ka.LAUNCHES_STAGE_ONE_ROW)
    gu, gv = ka.advect_stage_cuda(u, v, h, grid, cfg)
    one_row = int(shape[1] % ka.STRIP != 0)
    assert ka.LAUNCHES_STAGE - before[0] == 1
    assert ka.LAUNCHES_ONE_ROW - before[1] == one_row
    assert ka.LAUNCHES_STAGE_ONE_ROW - before[2] == one_row
    monkeypatch.setattr(ka, "advect_sample", ka.advect_sample_tiered_plain)
    wu, wv = ka.advect_stage_plain(u, v, h, grid, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(wu).all() and torch.isfinite(wv).all())
    differ = int((gu != wu).sum() + (gv != wv).sum())
    assert torch.equal(gu, wu) and torch.equal(gv, wv), differ


def test_advect_stage_raises_on_a_refused_launch(dev, monkeypatch):
    """A scalar table of another length than csrc/advect.cu's is refused
    by the stage's entry point, and the wrapper raises; nothing is
    counted."""
    import numpy as _np

    grid, h, u, v, cfg = _stage_case(256, 128, dev, False)
    real = ocean.stage_scalars
    before = (ka.LAUNCHES, ka.LAUNCHES_STAGE)
    monkeypatch.setattr(ocean, "stage_scalars", lambda g, c: _np.append(
        real(g, c), _np.float32(0.0)))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ka.advect_stage_cuda(u, v, h, grid, cfg)
    assert (ka.LAUNCHES, ka.LAUNCHES_STAGE) == before


BAND = (-1.0, 0.9, -PI, PI)  # x-periodic, clamped in y


def _project_case(W, H, coords, dev):
    """A terrain with coasts, random (u, v) and a random pressure whose
    gradient term is as large as (u, v) at mid-latitude."""
    grid, h, u, v = _case(W, H, coords, dev, seed=5)
    tab = ocean.project_tables(grid, dev)
    scale = float(0.1 / 0.5 * tab[H // 2] * tab[H + H // 2] * 100.0)
    p = torch.randn(grid.shape, generator=torch.Generator().manual_seed(6))
    return grid, (h - 0.05) * 20, u, v, (p * scale).to(dev)


def _redirects(fu, fv, terrain):
    """Sea pixels whose velocity points exactly along each of the 8
    directions, in ``ocean.project``'s order: the redirected ones (an
    unredirected velocity lies off these lines but by chance)."""
    sea = terrain <= 0
    counts = []
    for dx, dy in ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1),
                   (0, -1), (1, -1)):
        on = (torch.sign(fu) == dx) & (torch.sign(fv) == dy)
        if dx and dy:
            on &= fu.abs() == fv.abs()
        counts.append(int((sea & on & ((fu != 0) | (fv != 0))).sum()))
    return counts


@pytest.mark.parametrize("shape,coords", [((256, 128), GLOBAL),
                                          ((256, 120), GLOBAL),
                                          ((256, 128), BAND),
                                          ((250, 121), GLOBAL)],
                         ids=["global", "height-120", "band", "ragged"])
def test_project_stage_kernel_equals_twin(dev, shape, coords):
    """The projection kernel against ``ocean.project`` on the card, bit
    for bit, NaN-free, one launch; every one of the 8 redirect directions
    taken somewhere.  250x121 leaves partial blocks in both directions."""
    from demiurge_tpu_torch.kernels import project as kpr

    grid, h, u, v, p = _project_case(*shape, coords, dev)
    cfg = ocean.OceanConfig()
    before = kpr.LAUNCHES
    gu, gv = kpr.project_stage_cuda(u, v, p, h, grid, cfg)
    assert kpr.LAUNCHES - before == 1
    wu, wv = ocean.project(u, v, p, h, grid, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(wu).all() and torch.isfinite(wv).all())
    assert min(_redirects(wu, wv, h)) > 0, _redirects(wu, wv, h)
    differ = int((gu != wu).sum() + (gv != wv).sum())
    assert torch.equal(gu, wu) and torch.equal(gv, wv), differ


def test_project_stage_raises_on_a_refused_launch(dev, monkeypatch):
    """A scalar table of another length than csrc/project.cu's is refused
    by the entry point, and the wrapper raises; nothing is counted."""
    from demiurge_tpu_torch.kernels import project as kpr

    grid, h, u, v, p = _project_case(256, 128, GLOBAL, dev)
    real = ocean.project_scalars
    monkeypatch.setattr(ocean, "project_scalars", lambda c: np.append(
        real(c), np.float32(0.0)))
    before = kpr.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error"):
        kpr.project_stage_cuda(u, v, p, h, grid, ocean.OceanConfig())
    assert kpr.LAUNCHES == before


def test_project_stage_rejects_bad_inputs(dev):
    from demiurge_tpu_torch.kernels import project as kpr

    grid = Grid(64, 32)
    z = torch.zeros(grid.shape, device=dev)
    cfg = ocean.OceanConfig()
    before = kpr.LAUNCHES
    with pytest.raises(ValueError, match="float32"):
        kpr.project_stage_cuda(z, z, z.double(), z, grid, cfg)
    with pytest.raises(ValueError, match="shape"):
        kpr.project_stage_cuda(z, z, z, z[:16], grid, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        zt = torch.zeros(64, 32, device=dev).t()
        kpr.project_stage_cuda(zt, z, z, z, grid, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        kpr.project_stage_cuda(z, z, z, z.cpu(), grid, cfg)
    with pytest.raises(NotImplementedError):
        kpr.project_stage_cuda(z, z, z, z, Grid(64, 32, REGIONAL), cfg)
    assert kpr.LAUNCHES == before


def test_ocean_step_on_the_card_matches_the_cpu(dev):
    """Three steps at 256x128 on the card (tiered advect, Jacobi kernels)
    against the CPU (single-radius advect, plain twins): the two advect
    forms agree wherever no pixel is clamped, which holds at these
    speeds; the rest is f32 rounding of the card's libm.  The card's
    projection is one kernel launch a step, the CPU's none."""
    from demiurge_tpu_torch.kernels import launch_counts

    grid, h, _, _ = _case(256, 128, GLOBAL, dev)
    h = (h - 0.1) * 20
    cfg = ocean.OceanConfig(jacobi_iters=40, diffusion_iters=50)
    fields = {}
    for where in (dev, torch.device("cpu")):
        u, v = ocean.init_ocean(grid, where)
        hh = h.to(where)
        before = launch_counts()["ocean_project"]
        for _ in range(3):
            u, v, p, _ = ocean.ocean_step(u, v, hh, grid, cfg)
        launched = launch_counts()["ocean_project"] - before
        assert launched == (3 if where.type == "cuda" else 0), launched
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


# the band kernels' grids (tests/test_torch_climate_tiles.py and
# test_torch_blur_tiles.py run their schedules on the CPU): the coupled
# model's size, a ragged one, one block a band (128x64), H < 2k (64x12),
# an odd width, and the smaller grids the tests held before
BAND_GRIDS = [(2048, 1024), (2000, 1000), (128, 64), (64, 12), (1001, 500),
              (256, 128), (200, 100)]


def _same(got, want):
    """Bit for bit, NaN where the twin has NaN."""
    return torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(
        torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0))


def _climate_inputs(W, H, dev, substeps):
    from demiurge_tpu_torch.ops import temperature

    grid, h = _terrain(W, H, dev)
    T = temperature.init_temperature(grid, dev) + h
    i0 = torch.full((), 3.0, device=dev)
    asr = temperature.insolation_table(grid, i0, substeps, 0.30)
    cinv = (temperature.YEAR_SECONDS / temperature.SUBSTEPS_PER_YEAR
            / temperature.heat_capacity(h)).contiguous()
    return grid, T, cinv, asr


@pytest.mark.parametrize("shape", BAND_GRIDS + [(4096, 2048)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_climate_kernel_equals_plain_twin(dev, shape):
    """The coupled step's 10 substeps in at most 2 launches (was 10); at
    the climate CLI's 4096x2048 a dispatch's 250 substeps in at most 32
    (was 250), past the reference's stability bound on land: the NaNs and
    infs fall where the twin's do."""
    from demiurge_tpu_torch.kernels import climate as kc

    substeps, most = (250, 32) if shape == (4096, 2048) else (10, 2)
    grid, T, cinv, asr = _climate_inputs(*shape, dev, substeps)
    before = kc.LAUNCHES
    got = kc.climate_step_cuda(T, cinv, asr, grid, 0.55e6)
    want = kc.climate_step_plain(T, cinv, asr, grid, 0.55e6)
    torch.cuda.synchronize()
    assert kc.LAUNCHES - before == len(kc.card_launches(grid, substeps))
    assert kc.LAUNCHES - before <= most
    assert _same(got, want)
    if shape == (4096, 2048):
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        assert not bool(torch.isfinite(want).all())


@pytest.mark.parametrize("shape", BAND_GRIDS + [(8192, 4096)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("radius", [0.5, 3.0, 12.0])
def test_blur_kernel_equals_plain_twin(dev, shape, radius):
    """Radius 0.5 is the pre-blur (one launch, was 10); 3.0 has taps
    several rows away, across the poles; 12.0 runs 7 iterations, the
    widest of which outgrow a small grid's band (two one-pass launches)."""
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.ops.blur import sigma_list

    grid, h = _terrain(*shape, dev)
    rlist = sigma_list(radius)
    before = kb.LAUNCHES
    got = kb.blur_cuda(h, grid, rlist)
    want = kb.blur_plain(h, grid, rlist)
    torch.cuda.synchronize()
    plan = kb.card_launches(grid, rlist)
    assert kb.LAUNCHES - before == kb.launch_count(plan)
    if radius == 0.5:
        assert kb.launch_count(plan) == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(512, 256), (2048, 1024)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("group", [0, 1, 3])
def test_strip_kernels_equal_plain_forms(dev, shape, group):
    """K5 and K6's codes form on a row strip, as the mesh step launches
    them (``dist.local.flow_masks_rows``): row group ``group`` of 4 with
    its 7 halo rows, ending at a pole for groups 0 and 3 (the window's
    pole flag on there).  Each bit for bit against its plain form on the
    strip, and the strip's blur equal to the whole grid's at the strip's
    own rows."""
    from demiurge_tpu_torch.core.grid import Window
    from demiurge_tpu_torch.dist.local import flow_rows_reach
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.ops.blur import sigma_list

    grid, h = _terrain(*shape, dev)
    W, H = shape
    k, r = flow_rows_reach(0.5), H // 4
    lo, hi = max(group * r - k, 0), min((group + 1) * r + k, H)
    win = Window(W, hi - lo, grid.coords, grid.circumference, full=(W, H),
                 row0=lo)
    strip = h[lo:hi].contiguous()
    rlist = sigma_list(0.5)
    before = (kb.LAUNCHES_STRIP, kd.LAUNCHES_STRIP)
    hb = kb.blur_cuda(strip, win, rlist)
    code = kd.flow_directions_cuda(hb, torch.ones_like(hb), win)
    torch.cuda.synchronize()
    assert (kb.LAUNCHES_STRIP, kd.LAUNCHES_STRIP) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.equal(hb, kb.blur_plain(strip, win, rlist))
    assert torch.equal(code, kd.flow_directions_plain(hb, torch.ones_like(
        hb), win))
    whole = kb.blur_cuda(h, grid, rlist)
    own = slice(group * r - lo, group * r - lo + r)
    assert torch.equal(hb[own], whole[group * r:(group + 1) * r])


def test_band_kernels_raise_on_a_refused_launch(dev, monkeypatch):
    """A cluster that csrc/bands.cuh does not take (3 blocks) is refused
    by K1's and K5's entry points, and the wrappers raise; nothing is
    counted."""
    from demiurge_tpu_torch.kernels import bands
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import climate as kc
    from demiurge_tpu_torch.ops.blur import sigma_list

    grid, T, cinv, asr = _climate_inputs(1024, 512, dev, 10)
    before = (kc.LAUNCHES, kb.LAUNCHES)
    monkeypatch.setattr(bands, "cluster_of", lambda W, *a: 3)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kc.climate_step_cuda(T, cinv, asr, grid, 0.55e6)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kb.blur_cuda(T, grid, sigma_list(0.5))
    assert (kc.LAUNCHES, kb.LAUNCHES) == before


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


PACKED_GRIDS = {"256x128": (256, 128), "255x128": (255, 128),
                "96x48": (96, 48), "64x12": (64, 12),
                "2000x1000": (2000, 1000)}


@pytest.mark.parametrize("name", list(PACKED_GRIDS))
def test_directions_packed_kernel(dev, name):
    """The packed form in one launch: its codes equal the codes-only
    form's and the plain twin's but for knife-edge ties (at most one in
    10^4 pixels), and its packed field is exactly pack_masks of its own
    codes and their mouths (incoming_mask); odd W (the pole turn by
    round(W/2)), widths and heights below a tile, a grid no tile
    divides."""
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.ops import flow
    from demiurge_tpu_torch.ops.blur import blur

    grid, h = _terrain(*PACKED_GRIDS[name], dev)
    hb = blur(h, grid, 0.5)
    sel = torch.ones_like(hb)
    sel[:, :16] = 0.0
    sel[-3:, 40:60] = 0.0
    before = (kd.LAUNCHES, kd.LAUNCHES_PACKED)
    code, packed = kd.directions_packed_cuda(hb, sel, grid)
    assert (kd.LAUNCHES - before[0], kd.LAUNCHES_PACKED - before[1]) == (1, 1)
    only = kd.flow_directions_cuda(hb, sel, grid)
    plain = kd.flow_directions_plain(hb, sel, grid)
    _, mouth, _ = flow.incoming_mask(code, grid)
    want = kf.pack_masks(code, mouth, grid)
    torch.cuda.synchronize()
    assert code.dtype == packed.dtype == torch.int32
    assert torch.equal(code, only)
    assert int((code != plain).sum()) <= hb.numel() // 10000
    assert torch.equal(packed, want)
    assert bool(((packed >> 16) & 1).any())


def test_directions_kernels_raise_on_a_refused_launch(dev, monkeypatch):
    """A tile that csrc/directions.cu was not built for is refused by both
    entry points, and the wrappers raise; nothing is counted."""
    from demiurge_tpu_torch.kernels import directions as kd

    grid, h = _terrain(256, 128, dev)
    before = (kd.LAUNCHES, kd.LAUNCHES_PACKED)
    monkeypatch.setattr(kd, "TILE", (8, 128))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kd.flow_directions_cuda(h, torch.ones_like(h), grid)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kd.directions_packed_cuda(h, torch.ones_like(h), grid)
    assert (kd.LAUNCHES, kd.LAUNCHES_PACKED) == before


@pytest.mark.parametrize("case", ["cold", "warm", "serpentine", "ragged",
                                  "128x64", "96x48", "64x12"])
def test_flow_kernels_equal_plain_twins(dev, case):
    """K7's A bit for bit and K8's vis exactly against the plain twins:
    cold and from a warm start (the fixpoint of a slightly different
    terrain) at 256x128; the serpentine (one river of 24 columns x 150
    rows over the dateline of a 1000x200 grid, which the tiles do not
    divide); a 2000x1000 terrain, warm; and, warm, grids of one tile
    column (the golden 128x64, and 96x48 below a tile's width), where a
    tile's halo holds its own cells, and of one tile (64x12)."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.ops import flow
    from demiurge_tpu_torch.tools import serpentine

    W, H = {"ragged": (2000, 1000), "serpentine": (1000, 200),
            "128x64": (128, 64), "96x48": (96, 48), "64x12": (64, 12)}.get(
        case, (256, 128))
    if case == "serpentine":
        grid = Grid(W, H)
        packed, area = serpentine(grid, dev, W - 10, 24, 150)
        a0 = None
    else:
        grid, h = _terrain(W, H, dev)
        sel = torch.ones_like(h)
        area = flow.cell_area_lower_edge(grid, dev)

        def packed_of(height):
            hb = flow.blur(height, grid, 0.5)
            code = flow.flow_directions(hb, sel, grid)
            _, mouth, _ = flow.incoming_mask(code, grid)
            return kf.pack_masks(code, mouth, grid)

        a0 = None
        if case != "cold":
            a0 = kf.flow_solve_area_plain(packed_of(h * 1.01 + 0.01), area,
                                          grid)
        packed = packed_of(h)
    want_A = kf.flow_solve_area_plain(packed, area, grid, a0)
    want_vis = kf.vis_solve_plain(packed, grid)
    before = (kf.LAUNCHES_A, kf.LAUNCHES_VIS)
    A = kf.flow_solve_area_cuda(packed, area, grid, a0)
    sa = dict(kf.LAST_SOLVE["A"])
    vis = kf.vis_solve_cuda(packed, grid)
    sv = dict(kf.LAST_SOLVE["vis"])
    torch.cuda.synchronize()
    assert torch.equal(A, want_A) and torch.equal(vis, want_vis)
    assert kf.LAUNCHES_A - before[0] == sa["launched"]
    assert kf.LAUNCHES_VIS - before[1] == sv["launched"]
    for st in (sa, sv):
        assert 1 <= st["rounds"] <= st["launched"]
        assert 1 <= st["host_reads"] <= st["launched"]
        assert st["tiles_run"] >= 1 and st["max_inner_sweeps"] >= 1
    assert bool(want_vis.any()) and float(want_A.max()) > float(area.max())


def test_flow_kernels_raise_on_a_refused_launch(dev, monkeypatch):
    """A tile that csrc/flow.cu was not built for is refused by its entry
    points, and the wrappers raise (K7, K8 and K10's, which share the
    tile); nothing is counted."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow2 as k2

    grid, _, _, area, packed = _flow_inputs(256, 128, dev)
    before = (kf.LAUNCHES_A, kf.LAUNCHES_VIS, k2.LAUNCHES_LOCAL,
              k2.LAUNCHES_LOCAL_VIS)
    monkeypatch.setattr(kf, "TILE", (48, 128))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kf.flow_solve_area_cuda(packed, area, grid)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kf.vis_solve_cuda(packed, grid)
    ploc = k2.mask_local(packed, 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k2.flow_local_solve_cuda(ploc, area, area, 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k2.flow_local_vis_cuda(ploc, torch.zeros_like(area), 16)
    assert (kf.LAUNCHES_A, kf.LAUNCHES_VIS, k2.LAUNCHES_LOCAL,
            k2.LAUNCHES_LOCAL_VIS) == before


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


def test_erosion_loop_on_the_card_matches_the_cpu(dev):
    """Three iterations of the erosion loop with lakes (BASELINE config 1's
    path: K5, K6's codes form, the native lake solver, the relaxation) at
    256x128 on the card against the CPU: the height wherever the
    direction codes agree, as the coupled step's test allows."""
    from demiurge_tpu_torch.kernels import blur as kb
    from demiurge_tpu_torch.kernels import directions as kd
    from demiurge_tpu_torch.kernels import lakeflow as kl
    from demiurge_tpu_torch.native import lakes as nlakes
    from demiurge_tpu_torch.ops import erosion

    grid, h = _terrain(256, 128, dev)
    cfg = erosion.ErosionConfig(lakes=True)
    before = (kb.LAUNCHES, kd.LAUNCHES, kd.LAUNCHES_PACKED, nlakes.CALLS,
              kl.LAUNCHES)
    tiles0 = _lake_tile_launches()
    got = erosion.landscape_evolution(h, torch.ones_like(h), grid, cfg,
                                      iterations=3)
    after = (kb.LAUNCHES, kd.LAUNCHES, kd.LAUNCHES_PACKED, nlakes.CALLS,
             kl.LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [3, 3, 0, 3, 0]
    # K12's tiles: each of the 3 relaxations runs at least one batch of
    # rounds of each of A, vis and root; the one-sweep kernel none
    for a, b in zip(tiles0, _lake_tile_launches()):
        assert b - a >= 3 * 16 and (b - a) % 16 == 0
    want = erosion.landscape_evolution(h.cpu(), torch.ones(grid.shape),
                                       grid, cfg, iterations=3)
    got = got.cpu()
    assert bool(torch.isfinite(got).all())
    dh = (got - want).abs() / want.abs().max()
    assert float((dh > 1e-4).float().mean()) <= 1e-2


# ---------------------------------------------------------------------------
# the lake-aware relaxation (K12)
# ---------------------------------------------------------------------------


def _lake_tile_launches():
    from demiurge_tpu_torch.kernels import lakeflow as kl

    return (kl.LAUNCHES_AREA_TILES, kl.LAUNCHES_VIS_TILES,
            kl.LAUNCHES_ROOT_TILES)


def _lake_inputs(case, dev):
    """(grid, code, mouth, area, conn_from, conn_to, start state or None):
    the erosion CLI's inputs on a terrain with its native lake solution
    (no start: the solve's own, area, mouths and ``root_start``), or
    random codes with 40 random connections and a random start on a
    300x12 grid that 256-column blocks do not divide, on the globe or on
    a regional grid (tests/test_torch_lakeflow.py's cases), or a smooth
    terrain on a regional 300x12 grid with its native lake solution."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.native import lakes as nlakes
    from demiurge_tpu_torch.ops import flow

    if case.startswith("random-300x12"):
        rng = np.random.default_rng(11)
        grid = Grid(300, 12, (-0.4, 0.3, -1.0, 0.5)) \
            if case.endswith("regional") else Grid(300, 12)
        code = torch.from_numpy(rng.integers(0, 10, (12, 300)).astype(
            np.int32)).to(dev)
        _, mouth, _ = flow.incoming_mask(code, grid)
        tapped = np.flatnonzero(kf.pack_masks(code, mouth, grid).cpu(
            ).numpy().reshape(-1) & 0xFF)
        sinks = np.flatnonzero(code.cpu().numpy().reshape(-1) == 5)
        cfrom = rng.choice(sinks, 40, replace=False)
        cto = rng.choice(np.setdiff1d(tapped, cfrom), 40, replace=False)
        A = rng.uniform(0, 4, (12, 300)).astype(np.float32)
        start = (torch.from_numpy(A).to(dev),
                 torch.from_numpy(rng.random((12, 300)) < 0.5).to(dev),
                 torch.from_numpy(rng.integers(-1, 3600, (12, 300)).astype(
                     np.int32)).to(dev))
    else:
        if case == "regional-300x12":
            grid, h, _, _ = _case(300, 12, REGIONAL, dev)
            h = (h - 0.05) * 20
        else:
            W, H = (2000, 1000) if case == "2000x1000" else (256, 128)
            grid, h = _terrain(W, H, dev)
        code = flow.flow_directions(flow.blur(h, grid, 0.5),
                                    torch.ones_like(h), grid)
        mask, mouth, _ = flow.incoming_mask(code, grid)
        sol = nlakes.solve_lakes_native(
            mask.cpu().numpy().reshape(-1), mouth.cpu().numpy().reshape(-1),
            h.cpu().numpy().reshape(-1),
            flow.parent_pointers(code, grid).cpu().numpy(), grid)
        cfrom, cto = sol.conn_from, sol.conn_to
        if case == "no-connections":
            cfrom = cto = np.zeros(0, np.int64)
        start = None
    area = flow.cell_area_lower_edge(grid, dev)
    return (grid, code, mouth, area, torch.from_numpy(cfrom).to(dev),
            torch.from_numpy(cto).to(dev), start)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", ["256x128", "no-connections",
                                  "random-300x12", "random-300x12-regional",
                                  "2000x1000"])
def test_lake_relax_kernel_equals_twin(dev, case):
    """K12 against its twin: A, vis and root bit for bit after 1, 2, 7
    and 64 sweeps (both ping-pong sets), with and without the roots; the
    whole ``flow_solve_stencil`` on the card bit for bit with the CPU's,
    the same sweeps, K12 launched once a sweep."""
    from demiurge_tpu_torch.kernels import lakeflow as kl
    from demiurge_tpu_torch.ops import flow

    grid, code, mouth, area, cfrom, cto, start = _lake_inputs(case, dev)
    src, dst = kl.conn_fields(cfrom, cto, grid.shape)
    packed = kl.pack_lake_masks(code, mouth, grid, src, dst)
    if start is None:
        start = (area, mouth, kl.root_start(packed))
    for root in (start[2], None):
        for n in (1, 2, 7, 64):
            before = kl.LAUNCHES
            got = kl.relax_sweep_cuda(packed, area, src, dst, start[0],
                                      start[1], root, grid, n)
            torch.cuda.synchronize()
            assert kl.LAUNCHES == before + n
            want = kl.relax_sweep_twin(packed, area, src, dst, start[0],
                                       start[1], root, grid, n)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    assert torch.equal(_bits(g), _bits(w)), (case, n)
    if case.startswith("random-300x12"):
        return   # random codes may hold cycles: no fixpoint to solve
    # the whole solve on the card: the tiled kernels, not the one-sweep
    before, tiles0 = kl.LAUNCHES, _lake_tile_launches()
    got = flow.flow_solve_stencil(code, area, mouth, grid, conn_from=cfrom,
                                  conn_to=cto, want_root=True)
    stats = dict(flow.LAST_SOLVE)
    assert kl.LAUNCHES == before
    assert [b - a for a, b in zip(tiles0, _lake_tile_launches())] == [
        stats[k]["launched"] for k in ("A", "vis", "root")]
    want = flow.flow_solve_stencil(code.cpu(), area.cpu(), mouth.cpu(),
                                   grid, conn_from=cfrom.cpu(),
                                   conn_to=cto.cpu(), want_root=True)
    assert flow.LAST_SOLVE["sweeps"] > 0
    for g, w in zip(got, want):
        assert torch.equal(_bits(g.cpu()), _bits(w))
    assert bool(want[1].any()) and int((want[2] >= 0).sum()) > 0


@pytest.mark.parametrize("case", ["256x128", "no-connections", "2000x1000",
                                  "regional-300x12"])
def test_lake_tiled_solve_equals_twin_solve(dev, case):
    """K12's tiled solve against the twin's solve on the card's tensors: A
    bit for bit, vis and root exactly, with and without root; each solve
    certified by a round that wrote nothing, one host read a batch, the
    one-sweep kernel not launched."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import lakeflow as kl

    grid, code, mouth, area, cfrom, cto, _ = _lake_inputs(case, dev)
    assert grid.wrap_x == (case != "regional-300x12")
    src, dst = kl.conn_fields(cfrom, cto, grid.shape)
    packed = kl.pack_lake_masks(code, mouth, grid, src, dst)
    assert (int((src >= 0).sum()) == 0) == (case == "no-connections")
    for want_root in (True, False):
        before = kl.LAUNCHES
        A, vis, root, stats = kl.relax_solve(packed, area, src, dst, grid,
                                             want_root)
        torch.cuda.synchronize()
        assert kl.LAUNCHES == before
        wA, wvis, wroot, twin = kl.relax_solve_twin(packed, area, src, dst,
                                                    grid, want_root)
        assert torch.equal(_bits(A), _bits(wA)), case
        assert torch.equal(vis, wvis), case
        if want_root:
            assert root.dtype == torch.int32 and torch.equal(root, wroot)
        else:
            assert root is None and wroot is None
        assert set(stats) == ({"A", "vis", "root"} if want_root
                              else {"A", "vis"})
        for st in stats.values():
            assert 1 <= st["rounds"] <= st["launched"]
            assert st["launched"] % kf.BATCH == 0
            assert st["host_reads"] == st["launched"] // kf.BATCH
        assert twin["sweeps"] > 0 and bool(wvis.any())
        assert not want_root or int((wroot >= 0).sum()) > 0


def test_lake_tiled_solve_raises_on_a_refused_launch(dev, monkeypatch):
    """A tile the library was not built for is refused by the entry point
    and the wrapper raises; nothing is counted."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import lakeflow as kl

    grid, code, mouth, area, cfrom, cto, _ = _lake_inputs("256x128", dev)
    src, dst = kl.conn_fields(cfrom, cto, grid.shape)
    packed = kl.pack_lake_masks(code, mouth, grid, src, dst)
    monkeypatch.setattr(kf, "TILE", (8, 128))
    before = _lake_tile_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kl.relax_solve(packed, area, src, dst, grid, True)
    assert _lake_tile_launches() == before


def test_lake_relax_raises_on_a_refused_launch(dev):
    """A grid taller than a launch's 65535 block rows is refused by the
    entry point and the wrapper raises; nothing is counted."""
    from demiurge_tpu_torch.kernels import lakeflow as kl

    grid = Grid(4, 70000)
    z = torch.zeros(grid.shape, device=dev)
    i = torch.full(grid.shape, -1, dtype=torch.int32, device=dev)
    before = kl.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error"):
        kl.relax_sweep_cuda(torch.zeros_like(i), z, i, i, z, z > 0, None,
                            grid)
    assert kl.LAUNCHES == before


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


# K10's grids and bands (tests/test_torch_flow2_tiles.py runs the schedule
# on the CPU): 16-row tiles over 8 bands of 2, 2 of 8, one of 16 and half
# of 32; a grid the tiles do not divide; one tile column
LOCAL_FLOW_CASES = {
    "256x128-band2": (256, 128, 2),
    "256x128-band8": (256, 128, 8),
    "256x128-band16": (256, 128, 16),
    "256x128-band32": (256, 128, 32),
    "2000x1000-band8": (2000, 1000, 8),
    "128x64-band8": (128, 64, 8),
}


@pytest.mark.parametrize("name", list(LOCAL_FLOW_CASES))
def test_local_flow_kernels_equal_plain_twins(dev, name):
    """K10a's A and exit ids bit for bit, cold and from a warm start
    without exit ids, and K10b's vis exactly with an all-zero and a
    nonzero seed; the launches counted are the tile rounds."""
    from demiurge_tpu_torch.kernels import flow2 as k2

    W, H, band = LOCAL_FLOW_CASES[name]
    grid, _, _, area, packed = _flow_inputs(W, H, dev)
    ploc = k2.mask_local(packed, band)
    before = k2.LAUNCHES_LOCAL
    A, E = k2.flow_local_solve_cuda(ploc, area, area, band)
    sa, se = dict(k2.LAST_SOLVE["A"]), dict(k2.LAST_SOLVE["E"])
    wA, wE = k2.flow_local_solve_plain(ploc, area, area, band)
    torch.cuda.synchronize()
    assert torch.equal(A, wA) and torch.equal(E, wE)
    assert k2.LAUNCHES_LOCAL - before == sa["launched"] + se["launched"]
    # rivers: above 10x a cell's area at 256x128 from band 8 (21.6x), 8-9x
    # where band 2 or the 128x64 grid cut them
    rivers = 5 if band < 8 or W < 256 else 10
    assert bool((E >= 0).any())
    assert float(A.max()) > rivers * float(area.max())
    warm = torch.rand(grid.shape, device=dev) * 2 * area
    A2, E2 = k2.flow_local_solve_cuda(ploc, area, warm, band, with_exit=False)
    assert E2 is None and torch.equal(A2, wA)
    seed = torch.zeros(grid.shape, device=dev)
    seed[band - 1::band, ::7] = 1.0
    seed[band::band, 3::11] = 1.0
    for s in (torch.zeros_like(seed), seed):
        before = k2.LAUNCHES_LOCAL_VIS
        got = k2.flow_local_vis_cuda(ploc, s, band)
        sv = dict(k2.LAST_SOLVE["vis"])
        want = k2.flow_local_vis_plain(ploc, s, band)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert k2.LAUNCHES_LOCAL_VIS - before == sv["launched"]
    for st in (sa, se, sv):
        assert 1 <= st["rounds"] <= st["launched"]
        assert 1 <= st["host_reads"] <= st["launched"]
        assert st["tiles_run"] >= 1 and st["max_inner_sweeps"] >= 1


def test_local_flow_kernels_at_one_band_equal_k7_and_k8(dev):
    """One band of H rows has no crossing cell (no out bit leaves the
    grid), so K10a's A is K7's, its exit ids all -1, and K10b's vis with a
    zero seed is K8's (the same kernel at band 0), each equal to its
    twin."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow2 as k2

    grid, _, _, area, packed = _flow_inputs(256, 128, dev)
    A, E = k2.flow_local_solve_cuda(packed, area, area, 128)
    vis = k2.flow_local_vis_cuda(packed, torch.zeros_like(area), 128)
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    torch.cuda.synchronize()
    assert torch.equal(A, A7) and bool((E == -1).all())
    assert torch.equal(vis8, kf.vis_solve_plain(packed, grid))
    assert torch.equal(vis.bool(), vis8) and bool(vis8.any())


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


# ---------------------------------------------------------------------------
# the reference's alternative flow solvers (K11a-d) and the packed Jacobi
# (K11e)
# ---------------------------------------------------------------------------


def _deadend_solvers():
    from demiurge_tpu_torch.kernels import flow_deadends as kd

    return {
        "banded": (lambda p, a, g: kd.flow_solve_banded_rounds_cuda(
            p, a, g, band=16, k=8), lambda p, a, g:
            kd.flow_solve_banded_rounds_plain(p, a, g, band=16, k=8),
            "LAUNCHES_BANDED"),
        "banded-sweeps": (lambda p, a, g: kd.flow_solve_banded_sweeps_cuda(
            p, a, g, band=16, k=8), lambda p, a, g:
            kd.flow_solve_banded_rounds_plain(p, a, g, band=16, k=8),
            "LAUNCHES_BANDED_SWEEPS"),
        "tiles": (lambda p, a, g: kd.flow_solve_2d_cuda(p, a, g, k=8),
                  lambda p, a, g: kd.flow_solve_2d_plain(p, a, g, k=8),
                  "LAUNCHES_2D"),
        **{f"fused-{m}": (
            lambda p, a, g, m=m: kd.flow_solve_fused_cuda(
                p, a, g, band=32, narrow=128, mode=m),
            lambda p, a, g, m=m: kd.flow_solve_fused_plain(
                p, a, g, band=32, narrow=128, mode=m),
            "LAUNCHES_FUSED") for m in ("both", "A", "vis")},
        "fused-bands": (
            lambda p, a, g: kd.flow_solve_fused_bands_cuda(
                p, a, g, band=32, narrow=128),
            lambda p, a, g: kd.flow_solve_fused_plain(
                p, a, g, band=32, narrow=128), "LAUNCHES_FUSED_BANDS"),
        "wave": (kd.flow_solve_wave_cuda, kd.flow_solve_wave_plain,
                 "LAUNCHES_WAVE"),
    }


@pytest.mark.parametrize("name", ["banded", "banded-sweeps", "tiles",
                                  "fused-both", "fused-A", "fused-vis",
                                  "fused-bands", "wave"])
def test_deadend_flow_kernels_equal_plain_twins(dev, name):
    """A bit for bit and vis exactly against the twin; A bit for bit
    against K7 (the wave within rtol 1e-5, atol 1e-7: it adds arrivals in
    hop order) and vis against K8.  The fused solve (K11b) is one launch
    and one host read; "fused-bands" is its earlier design, the
    yardstick.  The banded rounds (K11d) on cluster windows are one launch
    and one host read a round; "banded-sweeps" is their earlier design, k
    launches a round."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd

    # 1536x384, fBm: long rivers, and the 2-D solve's 128x512 tiles come
    # 3x3, so tiles skip once the activity narrows
    from demiurge_tpu_torch.ops.noise import NoiseParams, fbm
    from demiurge_tpu_torch.tools import flow_inputs

    grid = Grid(1536, 384)
    packed, area = flow_inputs(fbm(grid, NoiseParams(
        octaves=4, scale=2.0, min=-2.0, max=3.0, seed=7), dev), grid)
    mouth = ((packed >> 16) & 1).bool()
    cuda, plain, counter = _deadend_solvers()[name]
    before = getattr(kd, counter)
    A, vis, stats = cuda(packed, area, grid)
    wA, wvis, _ = plain(packed, area, grid)
    torch.cuda.synchronize()
    launched = stats["launched"] if "launched" in stats else stats["launches"]
    assert getattr(kd, counter) - before == launched > 0
    if name.startswith("fused-") and name != "fused-bands":
        assert launched == stats["host_reads"] == 1
    if name == "tiles":  # the activity pass and k = 8 sweeps a round
        assert stats["launches"] == 9 * stats["rounds"]
    if name == "banded":
        assert launched == stats["host_reads"] == stats["rounds"]
        assert stats["cluster_runs"] == stats["band_runs"] * stats[
            "segments"] and stats["design"] == "cluster"
    if name == "banded-sweeps":
        assert launched == 8 * stats["rounds"] == 8 * stats["host_reads"]
    assert torch.equal(A, wA) and torch.equal(vis, wvis)
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    if name == "fused-vis":
        assert torch.equal(A, area)
    elif name == "wave":
        torch.testing.assert_close(A, A7, rtol=1e-5, atol=1e-7)
    else:
        assert torch.equal(A, A7)
    assert torch.equal(vis, mouth if name == "fused-A" else vis8)


# K11d on cluster windows (tests/test_torch_flow_banded_cluster.py runs the
# schedule on the CPU): three segments a band, the last narrower, at W 8192;
# two at W 4096; a river over the dateline and across band edges
BANDED_CASES = {"8192x256": (8192, 256, 64, 16),
                "4096x256": (4096, 256, 64, 16),
                "serpentine": (1024, 200, 8, 8)}


@pytest.mark.parametrize("case", list(BANDED_CASES))
def test_banded_cluster_equals_twin_and_k7_k8(dev, case):
    """K11d's cluster windows: A bit for bit with the twin and K7, vis
    equal to the twin's and K8's; one launch and one host read a round,
    every (band, segment) cluster run."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd
    from demiurge_tpu_torch.tools import serpentine

    W, H, band, k = BANDED_CASES[case]
    if case == "serpentine":
        grid = Grid(W, H)
        packed, area = serpentine(grid, dev, 1000, 48, 150)
    else:
        grid, _, _, area, packed = _flow_inputs(W, H, dev)
    plan = kd.plan_banded(H, W, band, k)
    assert plan.segments == {"8192x256": 3, "4096x256": 2,
                             "serpentine": 1}[case]
    before = kd.LAUNCHES_BANDED
    A, vis, st = kd.flow_solve_banded_rounds_cuda(packed, area, grid, band,
                                                  k)
    wA, wvis, wst = kd.flow_solve_banded_rounds_plain(packed, area, grid,
                                                      band, k)
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    torch.cuda.synchronize()
    assert kd.LAUNCHES_BANDED - before == st["launches"] == st["rounds"]
    assert st["host_reads"] == st["rounds"] >= 2
    assert st["cluster_runs"] == st["band_runs"] * plan.segments
    assert (st["cluster"], st["segments"], st["seg"]) == (
        kd.CLUSTER, plan.segments, plan.seg)
    assert 1 <= st["max_inner_sweeps"] <= k
    assert torch.equal(A, wA) and torch.equal(vis, wvis)
    assert torch.equal(A, A7) and torch.equal(vis, vis8)
    assert torch.equal(wA, A7) and wst["rounds"] >= 1


def test_banded_cluster_raises_and_takes_the_earlier_design_where_no_plan(
        dev, monkeypatch):
    """A solve that has not certified by ``max_rounds`` (1: the river
    needs more) raises after that many launches; a plan the
    entry point does not accept is refused and the wrapper raises,
    counting nothing; where no plan fits (band 256, k 256 at 1024x256)
    the cluster entry raises and the public entry runs the earlier design,
    bit for bit with K7 and K8."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd
    from demiurge_tpu_torch.tools import serpentine

    grid = Grid(1024, 200)
    packed, area = serpentine(grid, dev, 1000, 48, 150)
    _, _, st = kd.flow_solve_banded_rounds_cuda(packed, area, grid, 8, 8)
    assert st["rounds"] >= 2
    before = kd.LAUNCHES_BANDED
    with pytest.raises(RuntimeError, match="no fixpoint after 1 rounds"):
        kd.flow_solve_banded_rounds_cuda(packed, area, grid, 8, 8,
                                         max_rounds=1)
    assert kd.LAUNCHES_BANDED == before + 1
    with monkeypatch.context() as m:  # segments past the row's end
        m.setattr(kd, "plan_banded",
                  lambda *a, **kw: kd.BandedPlan(3, 1024))
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.flow_solve_banded_rounds_cuda(packed, area, grid, 8, 8)
    assert kd.LAUNCHES_BANDED == before + 1

    grid, _, _, area, packed = _flow_inputs(1024, 256, dev)
    assert kd.plan_banded(256, 1024, 256, 256) is None
    with pytest.raises(ValueError, match="no cluster plan"):
        kd.flow_solve_banded_rounds_cuda(packed, area, grid, 256, 256)
    before = (kd.LAUNCHES_BANDED, kd.LAUNCHES_BANDED_SWEEPS)
    A, vis, st = kd.flow_solve_banded_rounds(packed, area, grid, 256, 256)
    torch.cuda.synchronize()
    assert st["design"] == "sweeps" and kd.LAUNCHES_BANDED == before[0]
    assert kd.LAUNCHES_BANDED_SWEEPS - before[1] == st["launches"] > 0
    assert torch.equal(A, kf.flow_solve_area_cuda(packed, area, grid))
    assert torch.equal(vis, kf.vis_solve_cuda(packed, grid))


@pytest.mark.parametrize("coords", [GLOBAL, REGIONAL],
                         ids=["global", "regional"])
def test_packed_jacobi_kernel_equals_plain_twin(dev, coords):
    """Both solves bit for bit against the twin, and within phase 3's
    bounds of the coefficient-plane kernels K2 and K3."""
    from demiurge_tpu_torch.kernels import jacobi_packed as kp

    grid, h, u, v = _case(256, 128, coords, dev)
    div = ocean.divergence(u, v, h, grid, ocean.OceanConfig())
    coeffs = kj.coefficients(div, h, grid)
    p0 = torch.zeros_like(div)
    ob = kp.pack_ob(h, grid, sea_bit=True)
    tab = kp.row_table(grid, "pressure", dev)
    before = kp.LAUNCHES
    (got,) = kp.resident_call_packed_cuda(ob, tab, coeffs[5], [p0], grid, 41,
                                          True, False)
    (want,) = kp.resident_call_packed_plain(ob, tab, coeffs[5], [p0], grid,
                                            41, True, False)
    k2 = kj.pressure_solve_cuda(*coeffs, p0, grid, 41)
    torch.cuda.synchronize()
    assert kp.LAUNCHES - before == kp.launches(41) == 6
    assert torch.equal(got, want)
    assert _rel_err(got, k2) <= 1e-4

    dco = kj.diffusion_coefficients(h, grid)
    obv = kp.pack_ob(h, grid, sea_bit=False)
    tabv = kp.row_table(grid, "viscosity", dev)
    gu, gv = kp.resident_call_packed_cuda(obv, tabv, None, [u, v], grid, 50,
                                          False, True)
    wu, wv = kp.resident_call_packed_plain(obv, tabv, None, [u, v], grid, 50,
                                           False, True)
    ku, kv = kj.diffusion_solve_cuda(*dco, u, v, grid, 50)
    torch.cuda.synchronize()
    assert torch.equal(gu, wu) and torch.equal(gv, wv)
    assert _rel_err(gu, ku) <= 2e-5 and _rel_err(gv, kv) <= 2e-5


@pytest.mark.parametrize("name", list(JACOBI_GRIDS))
def test_packed_jacobi_tiles_equal_plain_twin(dev, name):
    """K11e on its tiles (tests/test_torch_jacobi_packed_tiles.py runs the
    schedule on the CPU): pressure with the sea mask and viscosity on (u,
    v) with the pole sign, bit for bit against the twin in ceil(iters / k)
    launches, on K2's grids and every remainder; the earlier one-launch-a-
    sweep design (the yardstick) bit for bit too."""
    from demiurge_tpu_torch.kernels import jacobi_packed as kp

    grid, h, u, v = _case(*JACOBI_GRIDS[name], dev)
    div = ocean.divergence(u, v, h, grid, ocean.OceanConfig())
    b = kj.coefficients(div, h, grid)[5]
    solves = [(kp.pack_ob(h, grid, True), kp.row_table(grid, "pressure", dev),
               b, [torch.zeros_like(div)], True, False, 200),
              (kp.pack_ob(h, grid, False),
               kp.row_table(grid, "viscosity", dev), None, [u, v], False,
               True, 50)]
    for ob, tab, bb, fields, sea, neg, depth in solves:
        for iters in _jacobi_iters(name, depth):
            before = (kp.LAUNCHES, kp.LAUNCHES_SWEEPS)
            got = kp.resident_call_packed_cuda(ob, tab, bb, fields, grid,
                                               iters, sea, neg)
            want = kp.resident_call_packed_plain(ob, tab, bb, fields, grid,
                                                 iters, sea, neg)
            torch.cuda.synchronize()
            assert (kp.LAUNCHES - before[0], kp.LAUNCHES_SWEEPS
                    - before[1]) == (math.ceil(iters / 8), 0)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), iters
        old = kp.resident_call_packed_sweeps_cuda(ob, tab, bb, fields, grid,
                                                  depth, sea, neg)
        want = kp.resident_call_packed_plain(ob, tab, bb, fields, grid,
                                             depth, sea, neg)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(old, want))


def test_packed_jacobi_raises_on_a_refused_launch(dev, monkeypatch):
    """Sweeps a launch or a tile that csrc/jacobi_packed.cu was not built
    for are refused by its entry point, and the wrapper raises; nothing is
    counted."""
    from demiurge_tpu_torch.kernels import jacobi_packed as kp

    grid, h, u, v = _case(256, 128, GLOBAL, dev)
    ob, tab = kp.pack_ob(h, grid, True), kp.row_table(grid, "pressure", dev)
    before = kp.LAUNCHES
    with monkeypatch.context() as m:
        m.setattr(kp, "SWEEPS_PER_LAUNCH", kp.SWEEPS_PER_LAUNCH + 1)
        with pytest.raises(RuntimeError, match="CUDA error"):
            kp.resident_call_packed_cuda(ob, tab, None, [u], grid, 20, True,
                                         False)
    monkeypatch.setattr(kp, "TILES", {1: (48, 128), 2: (32, 64)})
    with pytest.raises(RuntimeError, match="CUDA error"):
        kp.resident_call_packed_cuda(ob, tab, None, [u], grid, 20, True,
                                     False)
    assert kp.LAUNCHES == before


@pytest.mark.parametrize("case", ["256x128", "serpentine", "2000x1000"])
def test_fused_tiles_equal_twin_and_k7_k8(dev, case):
    """K11b's one persistent launch (tests/test_torch_flow_fused_tiles.py
    runs the schedule on the CPU), in every mode: A bit for bit with the
    twin and with K7, vis equal to the twin's and K8's; one launch and
    one host read a solve; a terrain, the serpentine over the dateline and
    a grid the tiles do not divide."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd
    from demiurge_tpu_torch.tools import serpentine

    if case == "serpentine":
        grid = Grid(1000, 200)
        packed, area = serpentine(grid, dev, 990, 24, 150)
    else:
        W, H = (256, 128) if case == "256x128" else (2000, 1000)
        grid, _, _, area, packed = _flow_inputs(W, H, dev)
    band = 8 if case == "serpentine" else (40 if case == "2000x1000"
                                           else 32)
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    mouth = ((packed >> 16) & 1).bool()
    for mode in kd.MODES:
        before = kd.LAUNCHES_FUSED
        A, vis, st = kd.flow_solve_fused_cuda(packed, area, grid, k=8,
                                              band=band, mode=mode)
        wA, wvis, _ = kd.flow_solve_fused_plain(packed, area, grid, k=8,
                                                band=band, mode=mode)
        torch.cuda.synchronize()
        assert kd.LAUNCHES_FUSED - before == st["launched"] == 1
        assert st["host_reads"] == 1 and st["rounds"] >= 1
        assert st["tiles_run"] >= st["rounds"] and st["blocks"] >= 1
        assert torch.equal(A, wA) and torch.equal(vis, wvis), mode
        assert torch.equal(A, area if mode == "vis" else A7), mode
        assert torch.equal(vis, mouth if mode == "A" else vis8), mode


def test_fused_tiles_raise_on_a_round_limit_and_a_refused_launch(
        dev, monkeypatch):
    """A solve that has not certified by ``max_rounds`` raises (the
    kernel stops, the host reads the status); a tile the library was not
    built for is refused by the entry point and the wrapper raises.  Both
    launches are counted only where the kernel ran."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd
    from demiurge_tpu_torch.tools import serpentine

    grid = Grid(1000, 200)
    packed, area = serpentine(grid, dev, 990, 24, 150)
    _, _, st = kd.flow_solve_fused_cuda(packed, area, grid, band=8, k=8)
    assert st["rounds"] >= 2
    kd.flow_solve_fused_cuda(packed, area, grid, band=8, k=8,
                             max_rounds=st["rounds"])
    before = kd.LAUNCHES_FUSED
    with pytest.raises(RuntimeError, match="no fixpoint after"):
        kd.flow_solve_fused_cuda(packed, area, grid, band=8, k=8,
                                 max_rounds=st["rounds"] - 1)
    assert kd.LAUNCHES_FUSED == before + 1
    monkeypatch.setattr(kf, "TILE", (48, 128))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kd.flow_solve_fused_cuda(packed, area, grid, band=8, k=8)
    assert kd.LAUNCHES_FUSED == before + 1


# K11a on TMA windows and K11c blocked in time (tests/test_torch_flow_2d_tma.py
# and tests/test_torch_flow_wave_tiles.py run their schedules on the CPU):
# a terrain at 128x64 and at 2000x1000 (the tiles divide neither side), one
# tile row, one tile column, and the serpentine over the dateline
NEW_K11_CASES = ["128x64", "2000x1000", "one-row", "one-column",
                 "serpentine"]


def _new_k11_inputs(case, dev):
    from demiurge_tpu_torch.tools import serpentine

    if case == "serpentine":
        grid = Grid(1024, 200)
        packed, area = serpentine(grid, dev, 1000, 48, 150)
        return grid, packed, area
    W, H = {"128x64": (128, 64), "2000x1000": (2000, 1000),
            "one-row": (2048, 16), "one-column": (128, 512)}[case]
    grid, _, _, area, packed = _flow_inputs(W, H, dev)
    return grid, packed, area


@pytest.mark.parametrize("case", NEW_K11_CASES)
def test_tma_tiles_equal_twin_and_k7_k8(dev, case):
    """K11a's one persistent launch on TMA windows: A bit for bit with the
    twin (on the card's tiles) and with K7, vis equal to the twin's and
    K8's; one launch and one host read a solve; k 8 (the public entry's),
    16, 4 and 1."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd

    grid, packed, area = _new_k11_inputs(case, dev)
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    wA, wvis, _ = kd.flow_solve_2d_plain(packed, area, grid, k=16,
                                         tiles=kf.TILE)
    assert torch.equal(wA, A7) and torch.equal(wvis, vis8)
    for k in (None, 16, 4, 1):
        before = kd.LAUNCHES_2D_TMA
        if k is None:
            A, vis, st = kd.flow_solve_2d(packed, area, grid)
            k = kd.TMA_K
        else:
            A, vis, st = kd.flow_solve_2d_tma_cuda(packed, area, grid, k)
        torch.cuda.synchronize()
        assert kd.LAUNCHES_2D_TMA - before == st["launched"] == 1
        assert st["host_reads"] == 1 and st["rounds"] >= 1 and st["k"] == k
        assert 1 <= st["max_inner_sweeps"] <= k and st["blocks"] >= 1
        assert torch.equal(A, wA) and torch.equal(vis, wvis), k


@pytest.mark.parametrize("case", NEW_K11_CASES)
def test_wave_tiles_equal_twin_and_k8(dev, case):
    """K11c blocked in time: A and vis bit for bit with the twin, vis equal
    to K8's, A within the reference's bound of K7's; one launch and one
    host read a solve; k 8 (the public entry's), 4, 12 and 16.  The last
    sweep that left a delta comes before the twin's certifying sweep."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd

    grid, packed, area = _new_k11_inputs(case, dev)
    A7 = kf.flow_solve_area_cuda(packed, area, grid)
    vis8 = kf.vis_solve_cuda(packed, grid)
    wA, wvis, wst = kd.flow_solve_wave_plain(packed, area, grid)
    for k in (None, 4, 12, 16):
        before = kd.LAUNCHES_WAVE_TILES
        if k is None:
            A, vis, st = kd.flow_solve_wave(packed, area, grid)
            k = kd.WAVE_K
        else:
            A, vis, st = kd.flow_solve_wave_tiles_cuda(packed, area, grid, k)
        torch.cuda.synchronize()
        assert kd.LAUNCHES_WAVE_TILES - before == st["launched"] == 1
        assert st["host_reads"] == 1 and st["sweeps"] == st["wave_rounds"] * k
        # the twin certifies one sweep after the last delta, or later
        # where vis takes longer
        assert st["wave_depth"] < wst["sweeps"]
        assert st["sweeps"] >= st["wave_depth"] and st["blocks"] >= 1
        assert torch.equal(A, wA) and torch.equal(vis, wvis), k
    assert torch.equal(wvis, vis8)
    torch.testing.assert_close(wA, A7, rtol=1e-5, atol=1e-7)


def test_new_k11_raise_on_a_round_limit_and_a_refused_launch(dev,
                                                             monkeypatch):
    """A solve that has not certified by ``max_rounds`` raises; a tile the
    library was not built for, and wave tiles the kernel does not take,
    are refused by the entry point and the wrapper raises; a launch is
    counted only where the kernel ran."""
    from demiurge_tpu_torch.kernels import flow as kf
    from demiurge_tpu_torch.kernels import flow_deadends as kd

    grid, packed, area = _new_k11_inputs("serpentine", dev)
    for solve, counter in ((kd.flow_solve_2d_tma_cuda, "LAUNCHES_2D_TMA"),
                           (kd.flow_solve_wave_tiles_cuda,
                            "LAUNCHES_WAVE_TILES")):
        _, _, st = solve(packed, area, grid)
        assert st["rounds"] >= 2
        solve(packed, area, grid, max_rounds=st["rounds"])
        before = getattr(kd, counter)
        with pytest.raises(RuntimeError, match="no fixpoint after"):
            solve(packed, area, grid, max_rounds=st["rounds"] - 1)
        assert getattr(kd, counter) == before + 1
    with monkeypatch.context() as m:
        m.setattr(kf, "TILE", (48, 128))
        before = kd.LAUNCHES_2D_TMA
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.flow_solve_2d_tma_cuda(packed, area, grid)
        assert kd.LAUNCHES_2D_TMA == before
    with monkeypatch.context() as m:
        m.setattr(kf, "TILE", (16, 64))
        before = kd.LAUNCHES_WAVE_TILES
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.flow_solve_wave_tiles_cuda(packed, area, grid)
        assert kd.LAUNCHES_WAVE_TILES == before
    with pytest.raises(ValueError, match="multiple of 16"):
        kd.flow_solve_2d_tma_cuda(packed[:, :1000].contiguous(),
                                  area[:, :1000].contiguous(),
                                  Grid(1000, 200))


@pytest.mark.parametrize("W", [1022, 516])
def test_wave_takes_the_earlier_design_where_the_tiles_do_not_fit(dev, W):
    """The wave's tiles need W a multiple of 4 (1022 is not) and, with more
    than three tile columns, a last column no narrower than k (516 leaves
    4): there ``flow_solve_wave`` runs the earlier design, one launch a
    sweep, bit for bit with the twin; the tiles' entry refuses the grid."""
    from demiurge_tpu_torch.kernels import flow_deadends as kd

    grid, _, _, area, packed = _flow_inputs(W, 256, dev)
    assert not kd.wave_tiles_take(grid)
    tA, tvis, tst = kd.flow_solve_wave_plain(packed, area, grid)
    before = (kd.LAUNCHES_WAVE, kd.LAUNCHES_WAVE_TILES)
    A, vis, st = kd.flow_solve_wave(packed, area, grid)
    torch.cuda.synchronize()
    assert kd.LAUNCHES_WAVE - before[0] == st["launches"] > 0
    assert kd.LAUNCHES_WAVE_TILES == before[1]
    assert torch.equal(A, tA) and torch.equal(vis, tvis)
    with pytest.raises(ValueError, match="the wave's tiles need"):
        kd.flow_solve_wave_tiles_cuda(packed, area, grid)

"""Iterations of the separable spherical blur.

Counterpart of ``demiurge_tpu/pallas_kernels/blur.py``.  For every radius
of ``ops.blur.sigma_list`` the blur runs two 13-tap passes of
``ops.blur.blur13_pass``:

- vertical: out = W0*f + sum_t w_t * (v0_t * f[row r+k_t] + v1_t * f[row
  r+k_t+1]) over the six row offsets o_t = +-offset*r, k_t = floor(o_t),
  v1_t = o_t - k_t, v0_t = 1 - v1_t; rows beyond a pole reflect to the
  other side, half a world round (``core.topology.shift``);
- horizontal: the same with per-row fractional column offsets
  +-offset*r/cos|phi|, each a column shift k_{t,r} (mod W) and a lerp
  weight pair, periodic in x.

The taps' shifts and weights depend only on the grid and the radius; they
are built once (``tables``) in float32 exactly as the plain twin derives
them, and stay on the device.  ``blur`` launches the CUDA kernel
(``csrc/blur.cu``) for CUDA tensors and runs the plain twin ``blur_plain``
— the ``blur13_pass`` sequence — for CPU tensors; both sum the taps in the
same order.  A launch runs a group of iterations on full-width row bands
in shared memory (``kernels/bands.py``), whose vertical reaches sum to the
band's halo; an iteration that alone outgrows a band runs as two one-pass
launches.  ``launches`` plans a call's.  ``LAUNCHES`` counts kernel
launches, ``LAUNCHES_STRIP`` those on a row window (``core.grid.Window``:
a rank's row group with its halo, ``dist.local``), whose tables are the
grid's at the window's rows and whose pole flags are on only where the
window ends at a pole.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, host_to_device, \
    use_cuda_kernels
from ..core.topology import _pole_col_shift
from . import bands

LAUNCHES = 0
LAUNCHES_STRIP = 0
TAPS = 6  # taps of one pass besides the center: 3 offsets x 2 signs
# a band's row (blur.cu): two buffers with margins, 4 ints; 128 floats of
# slack
LAYOUT = bands.Layout(planes=2, bare=0, ints=4, slack=128)

_TABLES: dict = {}


def blur_plain(field: torch.Tensor, grid: Grid, rlist) -> torch.Tensor:
    """Every iteration's vertical then horizontal pass, in plain PyTorch."""
    from ..ops.blur import blur13_pass

    for r in rlist:
        field = blur13_pass(field, grid, (0.0, r))
        field = blur13_pass(field, grid, (r, 0.0))
    return field


def tables(grid: Grid, rlist, device):
    """Per-grid, per-radius tap tables on ``device``:
    vk (n, 6) int32 row offsets; vw (n, 6, 2) float32 (v0, v1);
    hk (n, 6, H) int32 column shifts mod W; hw (n, 6, 2, H) float32;
    weights (4,) float32 (W0 and the three tap weights)."""
    key = (grid, tuple(rlist), str(device))
    if key in _TABLES:
        return _TABLES[key]
    from ..ops.blur import _W0, _WEIGHTS, horizontal_taps, vertical_taps

    n, H = len(rlist), grid.height
    vk = np.zeros((n, TAPS), np.int32)
    vw = np.zeros((n, TAPS, 2), np.float32)
    hk = np.zeros((n, TAPS, H), np.int32)
    hw = np.zeros((n, TAPS, 2, H), np.float32)
    for i, r in enumerate(rlist):
        for t, oy in enumerate(vertical_taps(r)):
            k = math.floor(oy)
            f = oy - k
            vk[i, t] = k
            vw[i, t] = (np.float32(1.0 - f), np.float32(f))
        for t, dx in enumerate(horizontal_taps(grid, r)):
            k = np.floor(dx).astype(np.int64)
            f = (dx - k).astype(np.float32)
            hk[i, t] = k % grid.width
            hw[i, t] = (np.float32(1.0) - f, f)
    weights = np.array([_W0, *_WEIGHTS], np.float32)
    out = tuple(host_to_device(a, device) for a in (vk, vw, hk, hw, weights))
    _TABLES[key] = out
    return out


def reach(r: float) -> int:
    """The vertical reach of an iteration of radius ``r``: the farthest row
    its taps read (blur.cu's ``max(kmax, -kmin)``)."""
    from ..ops.blur import vertical_taps

    out = 0
    for oy in vertical_taps(r):
        k = math.floor(oy)
        out = max(out, abs(k), abs(k + 1) if oy != k else 0)
    return out


def launches(grid: Grid, rlist, **plan_kw):
    """The launches of a call: ("band", first iteration, iterations,
    ``bands.Bands``) for a group of iterations whose reaches sum to at most
    the deepest halo a band takes, ("passes", iteration, 1, None) for an
    iteration that alone reaches farther (two launches).  ``plan_kw`` goes
    to ``bands.plan``."""
    W, H = grid.width, grid.height
    cap = bands.halo_max(W, LAYOUT, **plan_kw)
    out, group, depth = [], [], 0

    def close():
        if group:
            out.append(("band", group[0], len(group),
                        bands.plan(W, H, depth, LAYOUT, **plan_kw)))
            group.clear()

    for i, r in enumerate(rlist):
        R = reach(r)
        if group and (R > cap or depth + R > cap):
            close()
            depth = 0
        if R > cap:
            out.append(("passes", i, 1, None))
        else:
            group.append(i)
            depth += R
    close()
    return out


def card_launches(grid: Grid, rlist):
    """``launches`` with the clusters the card runs at once (builds the
    kernels), once per grid and radius list."""
    return _card_launches(grid, tuple(rlist))


@functools.lru_cache(maxsize=None)
def _card_launches(grid: Grid, rlist: tuple):
    return tuple(launches(grid, rlist, occupancy=functools.partial(
        bands.card_clusters, "demiurge_blur_band_clusters")))


def launch_count(plan) -> int:
    """Kernel launches of a plan: one a band group, two a lone iteration."""
    return sum(1 if kind == "band" else 2 for kind, *_ in plan)


def blur_cuda(field: torch.Tensor, grid: Grid, rlist) -> torch.Tensor:
    """Every iteration on the card: ``launches(grid, rlist)``, out of place,
    on the current stream, no synchronisation."""
    global LAUNCHES, LAUNCHES_STRIP
    check_kernel_inputs(("field",), (field,), shape=grid.shape)
    if not grid.wrap_x:
        raise NotImplementedError("the blur needs an x-periodic grid")
    n = len(rlist)
    if n == 0:
        return field.clone()
    from . import build

    vk, vw, hk, hw, weights = tables(grid, rlist, field.device)
    plan = card_launches(grid, rlist)
    H, W = grid.shape
    topo = (H, W, int(grid.wrap_south), int(grid.wrap_north),
            _pole_col_shift(grid))
    stream = torch.cuda.current_stream(field.device).cuda_stream
    lib = build.library()
    src = field
    for kind, i, m, b in plan:
        ptrs = (vk[i].data_ptr(), vw[i].data_ptr(), hk[i].data_ptr(),
                hw[i].data_ptr(), weights.data_ptr())
        dst = torch.empty_like(field)
        if kind == "band":
            err = lib.demiurge_blur_band(
                src.data_ptr(), *ptrs, dst.data_ptr(), *topo, m, b.halo,
                b.cluster, b.seg, b.th, stream)
            build.check(err, "demiurge_blur_band")
            LAUNCHES += 1
            LAUNCHES_STRIP += grid.base is not grid
        else:  # the vertical pass to tmp, the horizontal one to dst
            tmp = torch.empty_like(field)
            err = lib.demiurge_blur(src.data_ptr(), *ptrs, tmp.data_ptr(),
                                    dst.data_ptr(), *topo, 1, stream)
            build.check(err, "demiurge_blur")
            LAUNCHES += 2
            LAUNCHES_STRIP += 2 * (grid.base is not grid)
        src = dst
    return src


def blur(field: torch.Tensor, grid: Grid, rlist) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors on an x-periodic grid, the plain
    twin otherwise."""
    if use_cuda_kernels(field, grid=grid):
        return blur_cuda(field, grid, rlist)
    return blur_plain(field, grid, rlist)

"""The reference's alternative flow solvers: the (A, vis) fixpoint of
``kernels.flow`` reached four other ways.

Counterpart of ``attic/flow_deadends.py`` (``flow_solve_pallas_2d``,
``flow_solve_fused``, ``flow_solve_wave``) and of the banded rounds that
``tools/flow_rounds.py`` drives through ``pallas_kernels/flow.py``'s band
kernel.  The reference kept them as measured dead ends on its TPU; here
each is a kernel of its own (``csrc/flow_deadends.cu``), to be measured on
the card:

- ``flow_solve_banded_rounds`` (K11d): rounds of k sweeps over the row
  bands the last round's 3-bit flags wake (bit 0 changed, bit 1 changed
  within k rows of the low edge, bit 2 of the high edge); the host reads
  the flags every round and launches the sweeps on the woken bands only;
- ``flow_solve_2d`` (K11a): rounds of k sweeps on 2-D tiles that run when
  a tile of their 3x3 tile neighbourhood changed last round (x wraps, y
  clips); the skip test is on the device;
- ``flow_solve_fused`` (K11b): the whole solve in one cooperative launch:
  per-band column windows from the last round's change ranges, a round
  ended early by a sweep that wrote nothing, the stop test on the device;
  modes "both", "A" and "vis";
- ``flow_solve_wave`` (K11c): the delta wave, delta' = sum_i inc_i *
  delta[neighbour_i], A += delta', until delta is zero and vis still.

Each returns (A float32, vis bool, stats).  A equals K7's bit for bit (the
fixpoint is unique; ``csrc/flow_deadends.cu`` gives the argument that the
skip rules keep it) but for the wave, whose A adds arrivals in hop order.
Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
twin (Jacobi sweeps under the same rules) for CPU tensors.  The
``LAUNCHES_*`` counters count kernel launches: one a sweep for K11c and d,
one a sweep and one activity pass a round for K11a, one a solve for K11b.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import NEIGHBORS_FLOW_ORDER, shift
from .flow import solve_rounds_cuda
from .flow2 import pick_band

LAUNCHES_BANDED = 0
LAUNCHES_2D = 0
LAUNCHES_FUSED = 0
LAUNCHES_WAVE = 0

MODES = ("both", "A", "vis")
MAX_BANDS = 1024  # the banded kernel's by-value band list


def pick_tiles(H: int, W: int):
    """The reference's ``_pick_tiles``: (ty, tx) of the 2-D solve."""
    ty = next((b for b in (128, 64, 32) if H % b == 0), 0)
    tx = next((b for b in (512, 256, 128) if W % b == 0), 0)
    return ty, tx


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _check(packed, area, grid: Grid) -> None:
    if not grid.wrap_x:
        raise NotImplementedError("the flow solvers need an x-periodic grid")
    for name, t in (("packed", packed), ("area", area)):
        if tuple(t.shape) != grid.shape:
            raise ValueError(f"{name}: expected shape {grid.shape}, got "
                             f"{tuple(t.shape)}")


def _check_cuda(packed, area, grid: Grid) -> None:
    check_kernel_inputs(("packed",), (packed,), shape=grid.shape,
                        dtype=torch.int32)
    check_kernel_inputs(("area",), (area,), shape=grid.shape)
    _check(packed, area, grid)


def _max_sweeps(grid: Grid) -> int:
    # the longest path of an acyclic graph on H*W cells; a round sweeps at
    # least once, so this also bounds the rounds
    return grid.height * grid.width + 1


def _check_band(H: int, band: int, k: int) -> None:
    if band < 1 or H % band != 0:
        raise ValueError(f"band {band} does not divide {H} rows")
    if not 1 <= k <= band:
        raise ValueError(f"k must be in [1, band], got k {k}, band {band}")


class _PlainSweep:
    """One Jacobi sweep of the (A, vis) relaxation, in plain PyTorch."""

    def __init__(self, packed, area, grid: Grid):
        self.inc = [((packed >> i) & 1).bool() for i in range(8)]
        self.outs = [((packed >> (8 + i)) & 1).bool() for i in range(8)]
        self.mouth = ((packed >> 16) & 1).bool()
        self.area = area
        self.grid = grid

    def __call__(self, A, vis, mode: str = "both"):
        newA, newvis = A, vis
        if mode != "vis":
            newA = self.area
            for ok, (dx, dy) in zip(self.inc, NEIGHBORS_FLOW_ORDER):
                newA = newA + torch.where(
                    ok, shift(A, dx, dy, self.grid, pole_wrap=False), 0.0)
        if mode != "A":
            newvis = self.mouth
            for m, (dx, dy) in zip(self.outs, NEIGHBORS_FLOW_ORDER):
                newvis = newvis | (m & shift(vis, dx, dy, self.grid,
                                             pole_wrap=False))
        return newA, newvis

    def masked(self, A, vis, mask, mode: str = "both"):
        """A sweep of the cells in ``mask`` only: (A, vis, changed)."""
        newA, newvis = self(A, vis, mode)
        newA = torch.where(mask, newA, A)
        newvis = torch.where(mask, newvis, vis)
        changed = (newA != A) | (newvis != vis)
        return newA, newvis, changed


def _mouths_u8(packed) -> torch.Tensor:
    return ((packed >> 16) & 1).to(torch.uint8)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K11d: banded rounds with 3-bit band flags
# ---------------------------------------------------------------------------


def active_bands(flags) -> list:
    """The bands a round runs, from the last round's 3-bit flags: band b if
    its own bit 0 is set, bit 2 on band b-1 or bit 1 on band b+1."""
    n = len(flags)
    return [b for b in range(n)
            if flags[b] & 1 or (b > 0 and flags[b - 1] & 4)
            or (b < n - 1 and flags[b + 1] & 2)]


def band_flags(changed, band: int, k: int) -> list:
    """3-bit flags of each band from a (H, W) mask of the cells a round
    changed."""
    H = changed.shape[0]
    rows = changed.any(dim=1).reshape(H // band, band)
    rl = torch.arange(band, device=changed.device)
    bit1 = (rows & (rl < k)).any(dim=1)
    bit2 = (rows & (rl >= band - k)).any(dim=1)
    flags = rows.any(dim=1).int() | (bit1.int() << 1) | (bit2.int() << 2)
    return flags.tolist()


def _banded_stats(hist, k: int, launched: int) -> dict:
    return {"rounds": len(hist), "sweeps": len(hist) * k,
            "launches": launched, "active": hist, "band_runs": sum(hist)}


def flow_solve_banded_rounds_plain(packed, area, grid: Grid, band: int = 64,
                                   k: int = 16):
    """Plain twin of K11d: each round k Jacobi sweeps of the woken bands'
    rows."""
    _check(packed, area, grid)
    H, W = grid.shape
    _check_band(H, band, k)
    sweep = _PlainSweep(packed, area, grid)
    A, vis = area, sweep.mouth
    flags, hist = [7] * (H // band), []
    rows = torch.arange(H, device=area.device) // band
    while True:
        act = active_bands(flags)
        if not act:
            return A, vis, _banded_stats(hist, k, 0)
        if len(hist) >= _max_sweeps(grid):
            raise RuntimeError("banded rounds: no fixpoint (the flow graph "
                               "has a cycle)")
        mask = torch.isin(rows, torch.tensor(act, device=area.device)
                          ).reshape(-1, 1)
        changed = torch.zeros(grid.shape, dtype=torch.bool,
                              device=area.device)
        for _ in range(k):
            A, vis, ch = sweep.masked(A, vis, mask)
            changed |= ch
        flags = band_flags(changed, band, k)
        hist.append(len(act))


def flow_solve_banded_rounds_cuda(packed, area, grid: Grid, band: int = 64,
                                  k: int = 16):
    """K11d on the card: the host reads the band flags once a round and
    launches k in-place sweeps over the woken bands' rows."""
    global LAUNCHES_BANDED
    _check_cuda(packed, area, grid)
    H, W = grid.shape
    _check_band(H, band, k)
    if H // band > MAX_BANDS:
        raise ValueError(f"{H // band} bands, at most {MAX_BANDS}")
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    dflags = torch.empty(H // band, dtype=torch.int32, device=A.device)
    fn = build.library().demiurge_flow_banded_round
    flags, hist, launched = [7] * (H // band), [], 0
    while True:
        act = active_bands(flags)
        if not act:
            return A, vis.bool(), _banded_stats(hist, k, launched)
        if len(hist) >= _max_sweeps(grid):
            raise RuntimeError("banded rounds: no fixpoint (the flow graph "
                               "has a cycle)")
        bands = np.asarray(act, np.int32)
        build.check(fn(packed.data_ptr(), area.data_ptr(), A.data_ptr(),
                       vis.data_ptr(), dflags.data_ptr(), bands.ctypes.data,
                       len(act), H, W, band, k, _stream(A)),
                    "demiurge_flow_banded_round")
        LAUNCHES_BANDED += k
        launched += k
        flags = dflags.tolist()  # the round's one host read
        hist.append(len(act))


def flow_solve_banded_rounds(packed, area, grid: Grid, band: int = 64,
                             k: int = 16):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    Returns (A, vis, stats): rounds, sweeps (rounds * k), launches, the
    active bands of each round and their sum."""
    if use_cuda_kernels(packed, area):
        return flow_solve_banded_rounds_cuda(packed, area, grid, band, k)
    return flow_solve_banded_rounds_plain(packed, area, grid, band, k)


# ---------------------------------------------------------------------------
# K11a: 2-D tiles
# ---------------------------------------------------------------------------


def _tiles(grid: Grid, k: int):
    ty, tx = pick_tiles(*grid.shape)
    if not (ty and tx):
        raise ValueError(f"no tiles of (128|64|32, 512|256|128) divide "
                         f"{grid.shape}")
    if not 1 <= k <= min(ty, tx):
        raise ValueError(f"k must be in [1, min(ty, tx)], got {k}")
    return ty, tx


def tile_activity(flags: np.ndarray) -> np.ndarray:
    """(nby, nbx) bool: a tile of whose 3x3 neighbourhood (x wraps, y
    clips) changed."""
    f = np.pad(flags != 0, ((1, 1), (0, 0)))
    rows = f[:-2] | f[1:-1] | f[2:]
    return rows | np.roll(rows, 1, 1) | np.roll(rows, -1, 1)


def flow_solve_2d_plain(packed, area, grid: Grid, k: int = 16):
    """Plain twin of K11a: each round k Jacobi sweeps of the active
    tiles."""
    _check(packed, area, grid)
    ty, tx = _tiles(grid, k)
    H, W = grid.shape
    nby, nbx = H // ty, W // tx
    sweep = _PlainSweep(packed, area, grid)
    A, vis = area, sweep.mouth
    flags = np.ones((nby, nbx), np.int32)
    rounds = runs = 0
    while flags.any():
        if rounds >= _max_sweeps(grid):
            raise RuntimeError("2-D tiles: no fixpoint (the flow graph has "
                               "a cycle)")
        act = tile_activity(flags)
        runs += int(act.sum())
        mask = torch.from_numpy(act).to(area.device).repeat_interleave(
            ty, 0).repeat_interleave(tx, 1)
        changed = torch.zeros(grid.shape, dtype=torch.bool,
                              device=area.device)
        for _ in range(k):
            A, vis, ch = sweep.masked(A, vis, mask)
            changed |= ch
        flags = changed.reshape(nby, ty, nbx, tx).any(3).any(1).cpu().numpy()
        rounds += 1
    return A, vis, {"rounds": rounds, "sweeps": rounds * k, "launches": 0,
                    "tile_runs": runs, "tiles": (ty, tx)}


def flow_solve_2d_cuda(packed, area, grid: Grid, k: int = 16):
    """K11a on the card: per round an activity pass and k in-place sweeps,
    quiet tiles' blocks returning at once; one host read of the tile flags
    a round."""
    global LAUNCHES_2D
    _check_cuda(packed, area, grid)
    ty, tx = _tiles(grid, k)
    H, W = grid.shape
    nby, nbx = H // ty, W // tx
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    prev = torch.ones(nby * nbx, dtype=torch.int32, device=A.device)
    cur, act = torch.empty_like(prev), torch.empty_like(prev)
    fn = build.library().demiurge_flow_tiles_round
    flags = np.ones((nby, nbx), np.int32)
    rounds = runs = launched = 0
    while flags.any():
        if rounds >= _max_sweeps(grid):
            raise RuntimeError("2-D tiles: no fixpoint (the flow graph has "
                               "a cycle)")
        runs += int(tile_activity(flags).sum())
        build.check(fn(packed.data_ptr(), area.data_ptr(), A.data_ptr(),
                       vis.data_ptr(), prev.data_ptr(), cur.data_ptr(),
                       act.data_ptr(), H, W, ty, tx, k, _stream(A)),
                    "demiurge_flow_tiles_round")
        LAUNCHES_2D += k + 1  # the activity pass and k sweeps
        launched += k + 1
        flags = np.asarray(cur.tolist(), np.int32).reshape(nby, nbx)
        prev, cur = cur, prev
        rounds += 1
    return A, vis.bool(), {"rounds": rounds, "sweeps": rounds * k,
                           "launches": launched, "tile_runs": runs,
                           "tiles": (ty, tx)}


def flow_solve_2d(packed, area, grid: Grid, k: int = 16):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    The tiles are the reference's ``_pick_tiles``.  Returns (A, vis,
    stats): rounds, sweeps, launches, tile runs."""
    if use_cuda_kernels(packed, area):
        return flow_solve_2d_cuda(packed, area, grid, k)
    return flow_solve_2d_plain(packed, area, grid, k)


# ---------------------------------------------------------------------------
# K11b: the whole solve in one launch
# ---------------------------------------------------------------------------


def plan_windows(prev, W: int, k: int, narrow: int):
    """A round's swept windows from the last round's per-band change ranges
    ``prev`` [(lo, hi)], hi < 0 for none: band b sweeps the columns
    [lo - k, hi + k] (cyclic) of the merged range of bands b-1..b+1 when
    that fits in ``narrow`` columns, else the whole row.  Returns
    [(band, start, ncols)] and the count of narrow windows."""
    n, out, narrow_n = len(prev), [], 0
    for b in range(n):
        near = [prev[bb] for bb in range(max(b - 1, 0), min(b + 2, n))
                if prev[bb][1] >= 0]
        if not near:
            continue
        lo = min(r[0] for r in near)
        hi = max(r[1] for r in near)
        width = hi - lo + 1 + 2 * k
        if width <= narrow and width < W:
            out.append((b, (lo - k) % W, width))
            narrow_n += 1
        else:
            out.append((b, 0, W))
    return out, narrow_n


def _check_fused(grid: Grid, k: int, band: int, narrow: int, mode: str):
    H = grid.height
    band = band or pick_band(H)
    _check_band(H, band, k)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if narrow < 1:
        raise ValueError(f"narrow must be >= 1, got {narrow}")
    return band


def flow_solve_fused_plain(packed, area, grid: Grid, k: int = 16,
                           band: int = 0, narrow: int = 512,
                           mode: str = "both"):
    """Plain twin of K11b: the same rounds, windows and early stop, with
    Jacobi sweeps of the windowed cells."""
    _check(packed, area, grid)
    band = _check_fused(grid, k, band, narrow, mode)
    H, W = grid.shape
    nb = H // band
    dev = area.device
    sweep = _PlainSweep(packed, area, grid)
    A, vis = area, sweep.mouth
    prev = [(0, W - 1)] * nb
    cols = torch.arange(W, device=dev)
    stats = {"rounds": 0, "sweeps": 0, "band_visits": 0, "narrow_visits": 0,
             "launches": 0}
    while True:
        windows, narrow_n = plan_windows(prev, W, k, narrow)
        stats["band_visits"] += len(windows)
        stats["narrow_visits"] += narrow_n
        if not windows:
            return A, vis, stats
        if stats["rounds"] >= _max_sweeps(grid):
            raise RuntimeError("fused solve: no fixpoint (the flow graph "
                               "has a cycle)")
        stats["rounds"] += 1
        mask = torch.zeros((nb, W), dtype=torch.bool, device=dev)
        for b, start, n in windows:
            mask[b, (start + torch.arange(n, device=dev)) % W] = True
        mask = mask.repeat_interleave(band, 0)
        changed = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
        for _ in range(k):
            A, vis, ch = sweep.masked(A, vis, mask, mode)
            stats["sweeps"] += 1
            if not bool(ch.any()):
                break
            changed |= ch
        per_band = changed.reshape(nb, band, W).any(1)
        lo = torch.where(per_band, cols, W).min(1).values.tolist()
        hi = torch.where(per_band, cols, -1).max(1).values.tolist()
        prev = list(zip(lo, hi))


def flow_solve_fused_cuda(packed, area, grid: Grid, k: int = 16,
                          band: int = 0, narrow: int = 512,
                          mode: str = "both"):
    """K11b on the card: one cooperative launch, no host read inside it;
    the stats are read after it."""
    global LAUNCHES_FUSED
    _check_cuda(packed, area, grid)
    band = _check_fused(grid, k, band, narrow, mode)
    H, W = grid.shape
    nb = H // band
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    ws = torch.zeros(7 * nb + 9, dtype=torch.int32, device=A.device)
    ws[3 * nb:4 * nb] = W - 1  # round 0 sweeps every band in full
    blocks = np.zeros(1, np.int32)
    build.check(build.library().demiurge_flow_fused(
        packed.data_ptr(), area.data_ptr(), A.data_ptr(), vis.data_ptr(),
        ws.data_ptr(), H, W, band, k, narrow, MODES.index(mode),
        _max_sweeps(grid), blocks.ctypes.data, _stream(A)),
        "demiurge_flow_fused")
    LAUNCHES_FUSED += 1
    done, rounds, sweeps, visits, narrow_n = ws[7 * nb + 1:7 * nb + 9][
        [0, 4, 5, 6, 7]].tolist()
    if done != 1:
        raise RuntimeError("fused solve: no fixpoint (the flow graph has a "
                           "cycle)")
    return A, vis.bool(), {"rounds": rounds, "sweeps": sweeps,
                           "band_visits": visits, "narrow_visits": narrow_n,
                           "launches": 1, "blocks": int(blocks[0])}


def flow_solve_fused(packed, area, grid: Grid, k: int = 16, band: int = 0,
                     narrow: int = 512, mode: str = "both"):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    Mode "A" leaves vis at the mouths, mode "vis" leaves A at the area.
    Returns (A, vis, stats): rounds, sweeps, band visits, narrow visits."""
    if use_cuda_kernels(packed, area):
        return flow_solve_fused_cuda(packed, area, grid, k, band, narrow,
                                     mode)
    return flow_solve_fused_plain(packed, area, grid, k, band, narrow, mode)


# ---------------------------------------------------------------------------
# K11c: the delta wave
# ---------------------------------------------------------------------------


def flow_solve_wave_plain(packed, area, grid: Grid):
    """Plain twin of K11c, in K7's rounds (8 sweeps, doubling to 512) with
    one host read a round."""
    from .flow import FIRST_ROUND, MAX_ROUND

    _check(packed, area, grid)
    sweep = _PlainSweep(packed, area, grid)
    zero = torch.zeros_like(area)
    A, vis, delta = area, sweep.mouth, area
    n, sweeps, rounds = FIRST_ROUND, 0, 0
    while sweeps < _max_sweeps(grid):
        moved = []
        for _ in range(n):
            d = zero
            for ok, (dx, dy) in zip(sweep.inc, NEIGHBORS_FLOW_ORDER):
                d = d + torch.where(
                    ok, shift(delta, dx, dy, grid, pole_wrap=False), 0.0)
            _, newvis = sweep(A, vis, "vis")
            moved.append((d != 0).any() | (newvis != vis).any())
            A, vis, delta = A + d, newvis, d
        rounds += 1
        moved = torch.stack(moved).tolist()
        if False in moved:
            return A, vis, {"rounds": rounds,
                            "sweeps": sweeps + moved.index(False) + 1,
                            "launches": 0}
        sweeps += n
        n = min(2 * n, MAX_ROUND)
    raise RuntimeError("wave: no fixpoint (the flow graph has a cycle)")


def flow_solve_wave_cuda(packed, area, grid: Grid):
    """K11c on the card: delta in ping-pong buffers, A and vis in place, in
    K7's rounds."""
    global LAUNCHES_WAVE
    _check_cuda(packed, area, grid)
    H, W = grid.shape
    A, vis = area.clone(), _mouths_u8(packed)
    d0, d1 = area.clone(), torch.empty_like(area)
    first = [0]

    def args(flags, n):
        a = (packed.data_ptr(), d0.data_ptr(), d1.data_ptr(), A.data_ptr(),
             vis.data_ptr(), flags, H, W, first[0], n, _stream(A))
        first[0] += n
        return a

    stats = solve_rounds_cuda("demiurge_flow_wave_sweeps", args, A.device,
                              _max_sweeps(grid))
    LAUNCHES_WAVE += stats["launched"]
    return A, vis.bool(), {"rounds": stats["host_reads"],
                           "sweeps": stats["sweeps"],
                           "launches": stats["launched"]}


def flow_solve_wave(packed, area, grid: Grid):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    Returns (A, vis, stats): rounds (host reads), sweeps to the certifying
    one, launches."""
    if use_cuda_kernels(packed, area):
        return flow_solve_wave_cuda(packed, area, grid)
    return flow_solve_wave_plain(packed, area, grid)

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
  the flags every round.  On the card one launch a round: each woken
  band's window (its rows, k halo rows each side, a column segment and k
  halo columns each side) held in a thread-block cluster's distributed
  shared memory, up to k in-place sweeps there (``plan_banded`` picks the
  segments); ``flow_solve_banded_sweeps_cuda`` is the earlier design, k
  one-sweep launches a round, kept as the yardstick and run where no plan
  fits;
- ``flow_solve_2d`` (K11a): rounds of k sweeps on 2-D tiles that run when
  a tile of their 3x3 tile neighbourhood changed last round (x wraps, y
  clips).  The twin keeps the reference's tiles and Jacobi sweeps; the
  card runs K7's 16x128 tiles in one persistent cooperative launch, each
  visit's window loaded by TMA into shared memory after the visit before
  (no load in flight during a sweep), k in-place sweeps a visit, K7's
  edge-bit wake, the round's lists and the stop test on the device, one
  host read after it (``flow_solve_2d_cuda`` is the earlier, the
  reference's, design on the card: an activity pass and k one-sweep
  launches a round, kept as the yardstick; its tiles, the reference's,
  need W a multiple of 128, the tensor maps a multiple of 16);
- ``flow_solve_fused`` (K11b): the whole solve in one launch with the
  stop test on the device; modes "both", "A" and "vis".  The twin keeps
  the reference's design (per-band column windows from the last round's
  change ranges, a round ended early by a sweep that wrote nothing); the
  card runs K7/K8's tiles in one persistent cooperative launch, each
  round's list of (field, tile) visits and the stop test on the device,
  one host read after it (``flow_solve_fused_bands_cuda`` is the earlier,
  the reference's, design on the card, kept as the yardstick);
- ``flow_solve_wave`` (K11c): the delta wave, delta' = sum_i inc_i *
  delta[neighbour_i], A += delta', until delta is zero and vis still.  On
  the card the wave is blocked in time on K8's 16x128 tiles, k sweeps a
  round on a window with a k-cell halo, tiles whose window holds no delta
  skipped, and vis runs beside it on K8's tiles, in one persistent
  cooperative launch (``flow_solve_wave_cuda`` is the earlier design, one
  launch a sweep of every pixel, kept as the yardstick and run on the
  grids the tiles do not take: ``wave_tiles_take``).

Each returns (A float32, vis bool, stats).  A equals K7's bit for bit (the
fixpoint is unique; ``csrc/flow_deadends.cu`` gives the argument that the
skip rules keep it) but for the wave, whose A adds arrivals in hop order.
Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
twin (Jacobi sweeps under the same rules) for CPU tensors.  The
``LAUNCHES_*`` counters count kernel launches: one a round for K11d, one a
solve for K11a, b and c (``LAUNCHES_BANDED_SWEEPS``, ``LAUNCHES_2D``,
``LAUNCHES_WAVE`` and ``LAUNCHES_FUSED_BANDS`` count the earlier designs,
the yardsticks: one a sweep, one a sweep and one activity pass a round,
one a sweep, one a solve; 0 on every other path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import NEIGHBORS_FLOW_ORDER, shift
from . import flow as kf
from .flow2 import pick_band

LAUNCHES_BANDED = 0
LAUNCHES_BANDED_SWEEPS = 0
LAUNCHES_2D = 0
LAUNCHES_2D_TMA = 0
LAUNCHES_FUSED = 0
LAUNCHES_FUSED_BANDS = 0
LAUNCHES_WAVE = 0
LAUNCHES_WAVE_TILES = 0

MODES = ("both", "A", "vis")
MAX_BANDS = 1024  # the banded kernels' by-value band list
# on the card, K11a's in-place sweeps a visit and K11c's sweeps a round
# (PERF.md has the race)
TMA_K, WAVE_K = 8, 8


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


def _banded_stats(hist, k: int, launched: int, host_reads: int) -> dict:
    return {"rounds": len(hist), "sweeps": len(hist) * k,
            "launches": launched, "active": hist, "band_runs": sum(hist),
            "host_reads": host_reads}


# on the card: a cluster's blocks, and the sweeps a round of flow_tune's
# K11d row (PERF.md has the race)
CLUSTER, BANDED_K = 16, 16
SMEM_BYTES = 232448  # the shared memory a block may ask for (227 KB)
BAND_THREADS = 512   # the cluster kernel's block: a thread a window column
_SMEM_TAIL = 4 * (2 * 16 + 1)  # the sweeps' cluster flags, a block's bits


@dataclasses.dataclass(frozen=True)
class BandedPlan:
    """A round's geometry on the card: each woken band is ``segments``
    clusters of ``CLUSTER`` blocks, one a column segment of ``seg``
    columns (the last may be narrower; one segment is the whole row).  A
    window holds the band's rows, k rows each side, the segment's columns
    and k columns each side (none where one segment is the row: its ends
    meet), cut into ``CLUSTER`` contiguous slices."""

    segments: int
    seg: int

    def windows(self, W: int, k: int) -> list:
        """The window widths: the full segments' and the last's."""
        if self.segments == 1:
            return [W]
        last = W - (self.segments - 1) * self.seg
        return [self.seg + 2 * k, last + 2 * k]

    @staticmethod
    def slices(ww: int) -> tuple:
        """(columns a block, the last block's) of a window of ``ww``."""
        sw = -(-ww // CLUSTER)
        return sw, ww - (CLUSTER - 1) * sw


def banded_smem(rows: int, sw: int) -> int:
    """A block's shared bytes: ``sw`` columns of ``rows`` window rows (A
    and vis with a margin column each side, the area, the in and out
    bits), and the flags' tail."""
    return _SMEM_TAIL + rows * (11 * sw + 10)


def plan_banded(H: int, W: int, band: int, k: int):
    """The fewest segments a band whose windows fit: every block of a
    window holds a column (and at most ``BAND_THREADS``) in
    ``SMEM_BYTES``, and a window of several segments does not wrap onto
    itself (segment + 2k <= W).  None where no plan fits.  ``csrc/
    flow_deadends.cu`` (``banded::accepted``) checks the same rules."""
    _check_band(H, band, k)
    rows = band + 2 * k
    for n in range(1, W + 1):
        seg = -(-W // n)
        if n > 1 and (W - (n - 1) * seg < 1 or seg + 2 * k > W):
            continue
        plan = BandedPlan(n, seg)
        if all(last >= 1 and sw <= BAND_THREADS
               and banded_smem(rows, sw) <= SMEM_BYTES
               for sw, last in map(plan.slices, plan.windows(W, k))):
            return plan
    return None


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
            return A, vis, _banded_stats(hist, k, 0, len(hist))
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


def _check_banded_cuda(packed, area, grid: Grid, band: int, k: int):
    _check_cuda(packed, area, grid)
    H = grid.height
    _check_band(H, band, k)
    if H // band > MAX_BANDS:
        raise ValueError(f"{H // band} bands, at most {MAX_BANDS}")


def _rounds_cap(grid: Grid, max_rounds) -> int:
    cap = _max_sweeps(grid) if max_rounds is None else max_rounds
    if cap < 1:
        raise ValueError(f"max_rounds must be >= 1, got {cap}")
    return cap


def flow_solve_banded_rounds_cuda(packed, area, grid: Grid, band: int = 64,
                                  k: int = 16, *, max_rounds=None):
    """K11d on the card, redesigned: one launch a round.  Each woken band
    is ``plan_banded``'s segments, a cluster of ``CLUSTER`` blocks each,
    whose window (the band's rows and k each side, the segment's columns
    and k each side) lives in the blocks' shared memory; up to k in-place
    sweeps there, a cluster barrier after each, stopping after a quiet
    one; the band's own cells that changed go back with its 3-bit flags.
    The host reads the flags once a round (with the clusters that ran, the
    most sweeps a window ran and the blocks' clock cycles).  Raises where
    no plan fits (the public entry then takes the earlier design) and when
    ``max_rounds`` (default: the longest path an acyclic graph on the grid
    can hold) is reached.  Stats: the twin's (rounds, sweeps = rounds * k,
    launches, active, band_runs, host_reads) and cluster_runs,
    max_inner_sweeps, the plan (segments, seg), clusters_at_once
    (as the card reports it), design "cluster", and block_kcycles: the
    blocks' clock cycles / 1024, summed, loading windows, sweeping, at the
    sweeps' cluster barriers and writing back."""
    global LAUNCHES_BANDED
    _check_banded_cuda(packed, area, grid, band, k)
    H, W = grid.shape
    plan = plan_banded(H, W, band, k)
    if plan is None:
        raise ValueError(f"no cluster plan takes band {band}, k {k} at "
                         f"{W}x{H} in {CLUSTER}-block clusters")
    cap = _rounds_cap(grid, max_rounds)
    from . import build

    from .bands import card_clusters

    nb = H // band
    A, vis = area.clone(), _mouths_u8(packed)
    # two rounds' flags, each nb band words, the clusters run, the most
    # sweeps and 4 words of cycles: a round writes one and zeroes the other
    dflags = torch.zeros((2, nb + 6), dtype=torch.int32, device=A.device)
    fn = build.library().demiurge_flow_banded_cluster
    flags, hist, launched, runs, most = [7] * nb, [], 0, 0, 0
    kcycles = [0] * 4
    while True:
        act = active_bands(flags)
        if not act:
            sw = plan.slices(plan.windows(W, k)[0])[0]
            stats = _banded_stats(hist, k, launched, launched)
            stats.update(cluster_runs=runs, max_inner_sweeps=most,
                         cluster=CLUSTER, segments=plan.segments,
                         seg=plan.seg, clusters_at_once=card_clusters(
                             "demiurge_flow_banded_cluster_clusters",
                             CLUSTER, banded_smem(band + 2 * k, sw)),
                         design="cluster", block_kcycles=dict(zip(
                             ("load", "sweep", "sync", "write"), kcycles)))
            return A, vis.bool(), stats
        t = len(hist)
        if t >= cap:
            raise RuntimeError(f"banded rounds: no fixpoint after {t} "
                               f"rounds (the round limit; a flow graph "
                               f"with a cycle never certifies)")
        bands = np.asarray(act, np.int32)
        build.check(fn(packed.data_ptr(), area.data_ptr(), A.data_ptr(),
                       vis.data_ptr(), dflags[t & 1].data_ptr(),
                       dflags[(t + 1) & 1].data_ptr(), bands.ctypes.data,
                       len(act), H, W, band, k, CLUSTER,
                       plan.segments, plan.seg, _stream(A)),
                    "demiurge_flow_banded_cluster")
        LAUNCHES_BANDED += 1
        launched += 1
        row = dflags[t & 1].tolist()  # the round's one host read
        flags, ran = row[:nb], row[nb]
        if ran != len(act) * plan.segments:
            raise RuntimeError(f"banded rounds: {ran} clusters ran, "
                               f"{len(act) * plan.segments} launched")
        runs += ran
        most = max(most, row[nb + 1])
        kcycles = [a + b for a, b in zip(kcycles, row[nb + 2:])]
        hist.append(len(act))


def flow_solve_banded_sweeps_cuda(packed, area, grid: Grid, band: int = 64,
                                  k: int = 16):
    """The earlier K11d on the card, the yardstick: the host reads the
    band flags once a round and launches k in-place one-sweep kernels over
    the woken bands' rows.  Stats as the twin's, design "sweeps"."""
    global LAUNCHES_BANDED_SWEEPS
    _check_banded_cuda(packed, area, grid, band, k)
    H, W = grid.shape
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    dflags = torch.empty(H // band, dtype=torch.int32, device=A.device)
    fn = build.library().demiurge_flow_banded_sweeps
    flags, hist, launched = [7] * (H // band), [], 0
    while True:
        act = active_bands(flags)
        if not act:
            stats = _banded_stats(hist, k, launched, len(hist))
            stats["design"] = "sweeps"
            return A, vis.bool(), stats
        if len(hist) >= _max_sweeps(grid):
            raise RuntimeError("banded rounds: no fixpoint (the flow graph "
                               "has a cycle)")
        bands = np.asarray(act, np.int32)
        build.check(fn(packed.data_ptr(), area.data_ptr(), A.data_ptr(),
                       vis.data_ptr(), dflags.data_ptr(), bands.ctypes.data,
                       len(act), H, W, band, k, _stream(A)),
                    "demiurge_flow_banded_sweeps")
        LAUNCHES_BANDED_SWEEPS += k
        launched += k
        flags = dflags.tolist()  # the round's one host read
        hist.append(len(act))


def flow_solve_banded_rounds(packed, area, grid: Grid, band: int = 64,
                             k: int = 16):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    On the card the cluster windows where ``plan_banded`` finds a plan,
    else the earlier design, k one-sweep launches a round (stats'
    ``design`` says which).  Returns (A, vis, stats): rounds, sweeps
    (rounds * k), launches, the active bands of each round and their
    sum, host reads."""
    if use_cuda_kernels(packed, area):
        H, W = grid.shape
        _check_band(H, band, k)
        if plan_banded(H, W, band, k) is not None:
            return flow_solve_banded_rounds_cuda(packed, area, grid, band, k)
        return flow_solve_banded_sweeps_cuda(packed, area, grid, band, k)
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


def flow_solve_2d_plain(packed, area, grid: Grid, k: int = 16,
                        tiles=None):
    """Plain twin of K11a: each round k Jacobi sweeps of the active
    tiles.  ``tiles`` (ty, tx): the reference's ``_pick_tiles`` by default
    (it raises where none divide the grid); given, any tiles, ragged at the
    far edges, as the card's K11a runs K7's (the fixpoint is the same
    whatever the tiles)."""
    _check(packed, area, grid)
    H, W = grid.shape
    if tiles is None:
        ty, tx = _tiles(grid, k)
    else:
        ty, tx = tiles
        if not 1 <= k <= min(ty, tx):
            raise ValueError(f"k must be in [1, min(ty, tx)], got {k}")
    nby, nbx = -(-H // ty), -(-W // tx)
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
            ty, 0).repeat_interleave(tx, 1)[:H, :W]
        changed = torch.zeros((nby * ty, nbx * tx), dtype=torch.bool,
                              device=area.device)
        for _ in range(k):
            A, vis, ch = sweep.masked(A, vis, mask)
            changed[:H, :W] |= ch
        flags = changed.reshape(nby, ty, nbx, tx).any(3).any(1).cpu().numpy()
        rounds += 1
    return A, vis, {"rounds": rounds, "sweeps": rounds * k, "launches": 0,
                    "tile_runs": runs, "tiles": (ty, tx)}


def flow_solve_2d_cuda(packed, area, grid: Grid, k: int = 16):
    """The earlier K11a on the card, the yardstick: per round an activity
    pass and k in-place one-sweep launches, quiet tiles' blocks returning
    at once; one host read of the tile flags a round."""
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


def flow_solve_2d_tma_cuda(packed, area, grid: Grid, k: int = TMA_K, *,
                           max_rounds=None):
    """K11a on the card, redesigned: the whole (A, vis) solve in one
    persistent cooperative launch on K7's tiles (``kernels.flow.TILE``),
    as many blocks as fit, A's and vis's (field, tile) entries side by
    side; each visit's window (the tile, a row above and below, 4 columns
    of A or 16 of vis each side: 16 bytes, and a side box over the
    dateline) comes by TMA into shared memory; k in-place sweeps a visit,
    down then up, stopping after a quiet one; a visit that wrote wakes the
    tiles whose halo its edge bits face (K7's rule), and itself where its
    last sweep still wrote.  W must be a multiple of 16 (the tensor maps'
    rows).  ``max_rounds`` (default: the longest path an acyclic graph on
    the grid can hold) bounds the rounds: reaching it raises.  Stats:
    rounds, launched (1), host_reads (1), tiles_run (the visits, A's and
    vis's), max_inner_sweeps (the most sweeps of a visit), blocks, tiles,
    k, and block_kcycles: the blocks' clock cycles / 1024, summed, waiting
    for a window, sweeping, writing back and waking, at the grid syncs,
    and in all."""
    global LAUNCHES_2D_TMA
    _check_cuda(packed, area, grid)
    if grid.width % 16 or k < 1:
        raise ValueError(f"K11a's tensor maps need W a multiple of 16 (a "
                         f"row of vis in whole 16-byte units) and k >= 1, "
                         f"got W {grid.width}, k {k}")
    rounds_cap = _rounds_cap(grid, max_rounds)
    H, W = grid.shape
    ty, tx = kf.TILE
    ne = 2 * -(-H // ty) * -(-W // tx)
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    # two slots of wake words and of lists, then the control words
    ws = torch.zeros(4 * ne + 16, dtype=torch.int32, device=A.device)
    ws[2 * ne:3 * ne] = torch.arange(ne, dtype=torch.int32,
                                     device=A.device)  # round 0: all
    ws[4 * ne] = ne
    blocks = np.zeros(1, np.int32)
    build.check(build.library().demiurge_flow_2d_tma(
        packed.data_ptr(), area.data_ptr(), A.data_ptr(), vis.data_ptr(),
        ws.data_ptr(), H, W, ty, tx, k, rounds_cap, blocks.ctypes.data,
        _stream(A)), "demiurge_flow_2d_tma")
    LAUNCHES_2D_TMA += 1
    (visits, sweeps, _, status, rounds, *kcycles) = ws[4 * ne + 6:].tolist()
    if status != 1:
        raise RuntimeError(f"2-D tiles: no fixpoint after {rounds} rounds "
                           f"(the round limit; a flow graph with a cycle "
                           f"never certifies)")
    return A, vis.bool(), {"rounds": rounds, "launched": 1,
                           "host_reads": 1, "tiles_run": visits,
                           "max_inner_sweeps": sweeps,
                           "blocks": int(blocks[0]), "tiles": (ty, tx),
                           "k": k, "block_kcycles": dict(zip(
                               ("wait", "sweep", "write", "sync", "all"),
                               kcycles))}


def flow_solve_2d(packed, area, grid: Grid, k=None):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    The twin's tiles are the reference's ``_pick_tiles``, the card's K7's;
    ``k`` (sweeps a round or a visit) defaults to the reference's 16 for
    the twin and to the raced ``TMA_K`` on the card.  Returns (A, vis,
    stats): the twin's rounds, sweeps, launches, tile runs; the kernel's
    as ``flow_solve_2d_tma_cuda`` says."""
    if use_cuda_kernels(packed, area):
        return flow_solve_2d_tma_cuda(packed, area, grid,
                                      TMA_K if k is None else k)
    return flow_solve_2d_plain(packed, area, grid, 16 if k is None else k)


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
                          mode: str = "both", *, max_rounds=None):
    """K11b on the card: the whole solve in one persistent cooperative
    launch on K7/K8's tiles (``kernels.flow.TILE``), the rounds' lists of
    (field, tile) entries and the stop test on the device, and one host
    read after it (the status and the stats).  ``k``, ``band`` and
    ``narrow`` are the twin's: they are validated as the twin validates
    them and otherwise ignored, since the card's rounds are tile rounds.
    ``max_rounds`` (default: the longest path an acyclic graph on the grid
    can hold) bounds the rounds: reaching it raises.  Stats in
    ``kernels.flow.LAST_SOLVE``'s words: rounds (that visited an entry),
    launched (1), host_reads (1), tiles_run (the visits, A's and vis's),
    max_inner_sweeps (the most passes of a visit), and the blocks of the
    launch."""
    global LAUNCHES_FUSED
    _check_cuda(packed, area, grid)
    _check_fused(grid, k, band, narrow, mode)
    rounds_cap = _rounds_cap(grid, max_rounds)
    H, W = grid.shape
    ty, tx = kf.TILE
    # entries: (field, tile) pairs, A's and in mode "both" vis's
    ne = (2 if mode == "both" else 1) * -(-H // ty) * -(-W // tx)
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    # edges, two slots of wake words and of lists, then the control words
    ws = torch.zeros(5 * ne + 11, dtype=torch.int32, device=A.device)
    ws[3 * ne:4 * ne] = torch.arange(ne, dtype=torch.int32,
                                     device=A.device)  # round 0: all
    ws[5 * ne] = ne
    blocks = np.zeros(1, np.int32)
    build.check(build.library().demiurge_flow_fused(
        packed.data_ptr(), area.data_ptr(), A.data_ptr(), vis.data_ptr(),
        ws.data_ptr(), H, W, ty, tx, MODES.index(mode), rounds_cap,
        blocks.ctypes.data, _stream(A)), "demiurge_flow_fused")
    LAUNCHES_FUSED += 1
    visits, passes, _, status, rounds = ws[5 * ne + 6:].tolist()  # one read
    if status != 1:
        raise RuntimeError(f"fused solve: no fixpoint after {rounds} rounds "
                           f"(the round limit; a flow graph with a cycle "
                           f"never certifies)")
    return A, vis.bool(), {"rounds": rounds, "launched": 1,
                           "host_reads": 1, "tiles_run": visits,
                           "max_inner_sweeps": passes,
                           "blocks": int(blocks[0])}


def flow_solve_fused_bands_cuda(packed, area, grid: Grid, k: int = 16,
                                band: int = 0, narrow: int = 512,
                                mode: str = "both"):
    """The earlier K11b on the card, the yardstick: the twin's design (band
    windows, k sweeps a round, one pixel a thread, one grid sync a sweep)
    in one cooperative launch; the stats are read after it."""
    global LAUNCHES_FUSED_BANDS
    _check_cuda(packed, area, grid)
    band = _check_fused(grid, k, band, narrow, mode)
    H, W = grid.shape
    nb = H // band
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    ws = torch.zeros(7 * nb + 9, dtype=torch.int32, device=A.device)
    ws[3 * nb:4 * nb] = W - 1  # round 0 sweeps every band in full
    blocks = np.zeros(1, np.int32)
    build.check(build.library().demiurge_flow_fused_bands(
        packed.data_ptr(), area.data_ptr(), A.data_ptr(), vis.data_ptr(),
        ws.data_ptr(), H, W, band, k, narrow, MODES.index(mode),
        _max_sweeps(grid), blocks.ctypes.data, _stream(A)),
        "demiurge_flow_fused_bands")
    LAUNCHES_FUSED_BANDS += 1
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
    Returns (A, vis, stats): the twin's rounds, sweeps, band visits and
    narrow visits; the kernel's as ``flow_solve_fused_cuda`` says."""
    if use_cuda_kernels(packed, area):
        return flow_solve_fused_cuda(packed, area, grid, k, band, narrow,
                                     mode)
    return flow_solve_fused_plain(packed, area, grid, k, band, narrow, mode)


# ---------------------------------------------------------------------------
# K11c: the delta wave
# ---------------------------------------------------------------------------


def flow_solve_wave_plain(packed, area, grid: Grid):
    """Plain twin of K11c, in K7's rounds (8 sweeps, doubling to 512) with
    one host read a round.  Stats: rounds, sweeps (to the certifying one),
    launches (0), delta_cells (the cells with a nonzero delta, summed over
    the sweeps: the wave's own work)."""
    from .flow import FIRST_ROUND, MAX_ROUND

    _check(packed, area, grid)
    sweep = _PlainSweep(packed, area, grid)
    zero = torch.zeros_like(area)
    A, vis, delta = area, sweep.mouth, area
    n, sweeps, rounds, cells = FIRST_ROUND, 0, 0, 0
    while sweeps < _max_sweeps(grid):
        moved, live = [], []
        for _ in range(n):
            d = zero
            for ok, (dx, dy) in zip(sweep.inc, NEIGHBORS_FLOW_ORDER):
                d = d + torch.where(
                    ok, shift(delta, dx, dy, grid, pole_wrap=False), 0.0)
            _, newvis = sweep(A, vis, "vis")
            live.append((d != 0).sum())
            moved.append((live[-1] > 0) | (newvis != vis).any())
            A, vis, delta = A + d, newvis, d
        rounds += 1
        moved = torch.stack(moved).tolist()
        cells += int(torch.stack(live).sum())
        if False in moved:
            return A, vis, {"rounds": rounds,
                            "sweeps": sweeps + moved.index(False) + 1,
                            "launches": 0, "delta_cells": cells}
        sweeps += n
        n = min(2 * n, MAX_ROUND)
    raise RuntimeError("wave: no fixpoint (the flow graph has a cycle)")


def flow_solve_wave_cuda(packed, area, grid: Grid):
    """The earlier K11c on the card, the yardstick: one launch a sweep of
    every pixel, delta in ping-pong buffers, A and vis in place, in K7's
    rounds."""
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

    stats = kf.solve_rounds_cuda("demiurge_flow_wave_sweeps", args, A.device,
                              _max_sweeps(grid))
    LAUNCHES_WAVE += stats["launched"]
    return A, vis.bool(), {"rounds": stats["host_reads"],
                           "sweeps": stats["sweeps"],
                           "launches": stats["launched"]}


def wave_tiles_take(grid: Grid, k: int = WAVE_K) -> bool:
    """Whether the wave's tiles (K8's) take the grid: W a multiple of 4 (a
    copy of 4 floats lies in one tile) and, with more than three tile
    columns, k at most the ragged last column's width (a window stays in
    its 3x3 tiles)."""
    tx, W = kf.TILE[1], grid.width
    return W % 4 == 0 and not (W % tx and W % tx < k and -(-W // tx) > 3)


def check_wave_tiles(grid: Grid, k: int) -> None:
    """Raise unless the wave's tiles take (grid, k): k a multiple of 4 in
    [4, the tile's rows] and ``wave_tiles_take``."""
    rows = kf.TILE[0]
    if not 4 <= k <= rows or k % 4:
        raise ValueError(f"the wave's tiles: k a multiple of 4 in [4, "
                         f"{rows}], got {k}")
    if not wave_tiles_take(grid, k):
        raise ValueError(f"the wave's tiles need W a multiple of 4 and, "
                         f"with more than three tile columns, the last "
                         f"column no narrower than k = {k}: got W "
                         f"{grid.width}")


def flow_solve_wave_tiles_cuda(packed, area, grid: Grid, k: int = WAVE_K, *,
                               max_rounds=None):
    """K11c on the card, redesigned: the wave blocked in time on K8's
    tiles, k sweeps a round on the tile's window (a k-cell halo of delta
    and of the incoming bits) in shared memory, A summed in registers in
    sweep order and written once a round, the tile's last delta to the
    other of two buffers; a tile runs only where a tile of its 3x3
    neighbourhood left a nonzero delta, and a window reads a tile's delta
    only where that tile's last nonzero output is the last round's.  vis
    runs beside it as K8's visits on K8's tiles, all in one persistent
    cooperative launch with one host read.  A is bit for bit the twin's.
    Stats: rounds, wave_rounds, sweeps (wave_rounds * k), wave_depth (the
    last sweep that left a nonzero delta), wave_visits, vis_visits, tiles
    (the wave's), launched (1), host_reads (1), max_inner_sweeps (vis's),
    blocks, k, and block_kcycles: the blocks' clock cycles / 1024,
    summed, loading wave windows, sweeping them, writing out, in vis
    visits, at the grid syncs, and in all."""
    global LAUNCHES_WAVE_TILES
    _check_cuda(packed, area, grid)
    check_wave_tiles(grid, k)
    rounds_cap = _rounds_cap(grid, max_rounds)
    H, W = grid.shape
    ty, tx = kf.TILE
    ntw = -(-H // ty) * -(-W // tx)
    ne = 2 * ntw
    from . import build

    A, vis = area.clone(), _mouths_u8(packed)
    d0, d1 = area.clone(), torch.empty_like(area)
    # edges, two slots of wake words and of lists, the tiles' live rounds,
    # then the control words
    ws = torch.zeros(5 * ne + 2 * ntw + 22, dtype=torch.int32,
                     device=A.device)
    ws[3 * ne:4 * ne] = torch.arange(ne, dtype=torch.int32,
                                     device=A.device)  # round 0: all
    ws[5 * ne:5 * ne + ntw] = -2
    ws[5 * ne + ntw:5 * ne + 2 * ntw] = -1  # round 0 reads the area
    ctl = 5 * ne + 2 * ntw
    ws[ctl] = ne
    blocks = np.zeros(1, np.int32)
    build.check(build.library().demiurge_flow_wave_tiles(
        packed.data_ptr(), A.data_ptr(), vis.data_ptr(), d0.data_ptr(),
        d1.data_ptr(), ws.data_ptr(), H, W, ty, tx, k, rounds_cap,
        blocks.ctypes.data, _stream(A)), "demiurge_flow_wave_tiles")
    LAUNCHES_WAVE_TILES += 1
    (wave_visits, vis_visits, passes, _, status, rounds, wave_rounds,
     depth, _, _, *kcycles) = ws[ctl + 6:].tolist()  # one read
    if status != 1:
        raise RuntimeError(f"wave tiles: no fixpoint after {rounds} rounds "
                           f"(the round limit; a flow graph with a cycle "
                           f"never certifies)")
    return A, vis.bool(), {"rounds": rounds, "wave_rounds": wave_rounds,
                           "sweeps": wave_rounds * k, "wave_depth": depth,
                           "wave_visits": wave_visits,
                           "vis_visits": vis_visits, "tiles": ntw,
                           "launched": 1, "host_reads": 1,
                           "max_inner_sweeps": passes,
                           "blocks": int(blocks[0]), "k": k,
                           "block_kcycles": dict(zip(
                               ("load", "sweep", "write", "vis", "sync",
                                "all"), kcycles))}


def flow_solve_wave(packed, area, grid: Grid):
    """The CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    On the card the wave on tiles where ``wave_tiles_take`` the grid, else
    the earlier design, one launch a sweep.  Returns (A, vis, stats): the
    twin's rounds (host reads), sweeps to the certifying one, launches and
    delta cells; the earlier design's rounds, sweeps and launches; the
    tiles' as ``flow_solve_wave_tiles_cuda`` says."""
    if use_cuda_kernels(packed, area):
        if wave_tiles_take(grid):
            return flow_solve_wave_tiles_cuda(packed, area, grid)
        return flow_solve_wave_cuda(packed, area, grid)
    return flow_solve_wave_plain(packed, area, grid)

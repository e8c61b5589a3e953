"""Launch plans of the band kernels (``csrc/bands.cuh``): K1, the climate
substeps, and K5, the blur iterations.

A launch of either runs several passes on full-width row bands: a band
holds ``th`` output rows of the grid and ``halo`` rows on each side, whole,
in the shared memory of a cluster of ``cluster`` blocks, each block
``seg`` columns of every row (and ``MARGIN`` copies of its neighbours'
columns on either side, in the planes that are read at column shifts).
A pass of vertical reach R leaves the rows within R of the band's edge
wrong, so a launch's passes may reach ``halo`` rows in all.  This module
picks the geometry from the grid's width, the words a band keeps a row
(``Layout``) and a block's shared memory; the kernels check it and refuse
a geometry that does not cover the grid.  Pure Python: the CPU
tests (``tests/test_torch_climate_tiles.py``,
``tests/test_torch_blur_tiles.py``) run these plans in numpy.
"""

from __future__ import annotations

import dataclasses
import functools

SMEM_BYTES = 232448     # the shared memory a block may ask for (227 KB)
SEGMENT = 256           # a block's columns, as near as the cluster allows
CLUSTER_MAX = 16        # blocks a cluster (above 8: non-portable on sm_90)
SMS = 132               # an H100 SXM's multiprocessors: bands to fill them
MARGIN = 32             # a block's copies of its neighbours' columns a side


@dataclasses.dataclass(frozen=True)
class Layout:
    """A band's words a row: ``planes`` planes with margins, ``bare``
    planes without, ``ints`` of the row table; and ``slack`` words past
    the last row."""

    planes: int
    bare: int
    ints: int
    slack: int

    def words(self, seg: int) -> int:
        return self.planes * (seg + 2 * MARGIN) + self.bare * seg + self.ints


@dataclasses.dataclass(frozen=True)
class Bands:
    """One launch's geometry: a cluster of ``cluster`` blocks of ``seg``
    columns holds a band of ``th`` rows and ``halo`` rows a side."""

    cluster: int
    seg: int
    th: int
    halo: int

    @property
    def rows(self) -> int:
        """Extended rows of a band (eh)."""
        return self.th + 2 * self.halo

    def smem(self, layout: Layout) -> int:
        """A block's shared memory in bytes (as the kernel asks for it)."""
        return 4 * (layout.words(self.seg) * self.rows + layout.slack)

    def nbands(self, H: int) -> int:
        return -(-H // self.th)


def cluster_of(W: int, segment: int = SEGMENT) -> int:
    """The least power-of-two cluster whose blocks hold at most
    ``segment`` columns each, at most ``CLUSTER_MAX``, and fewer where a
    block would hold less than ``MARGIN`` (the kernels refuse that)."""
    c = 1
    while c < CLUSTER_MAX and c * segment < W:
        c *= 2
    while c > 1 and W - (c - 1) * -(-W // c) < MARGIN:
        c //= 2
    return c


def rows_max(W: int, layout: Layout, segment: int = SEGMENT,
             smem: int = SMEM_BYTES) -> int:
    """The most extended rows a band of this width can hold."""
    seg = -(-W // cluster_of(W, segment))
    return (smem // 4 - layout.slack) // layout.words(seg)


def halo_max(W: int, layout: Layout, segment: int = SEGMENT,
             smem: int = SMEM_BYTES, occupancy=None) -> int:
    """The deepest halo a launch takes: a quarter of the band's rows, so
    that at least half of them are output rows (``occupancy``, which only
    ``plan`` reads, is taken so that both take the same keywords)."""
    return rows_max(W, layout, segment, smem) // 4


def plan(W: int, H: int, halo: int, layout: Layout,
         segment: int = SEGMENT, smem: int = SMEM_BYTES,
         occupancy=None) -> Bands:
    """The geometry of a launch whose passes reach ``halo`` rows.  The
    bands come in waves of as many clusters as the card runs at once
    (``occupancy(cluster, smem)``; by default one block a multiprocessor
    of an H100): the fewest waves whose bands fit, every wave full, the
    bands of about the same height and, on small grids, at least twice as
    tall as the halo."""
    cluster = cluster_of(W, segment)
    seg = -(-W // cluster)
    th_max = rows_max(W, layout, segment, smem) - 2 * halo
    if halo < 1 or th_max < 1 or W < MARGIN:
        raise ValueError(f"a band of width {W} cannot hold a halo of "
                         f"{halo} rows")
    at_once = max(1, SMS // cluster if occupancy is None
                  else occupancy(cluster, smem))
    fit = -(-H // th_max)
    nb = -(-fit // at_once) * at_once
    nb = max(fit, min(nb, -(-H // min(th_max, 2 * halo))))
    return Bands(cluster, seg, -(-H // nb), halo)


@functools.lru_cache(maxsize=None)
def card_clusters(entry: str, cluster: int, smem: int) -> int:
    """How many clusters of ``cluster`` blocks with ``smem`` bytes each of
    the kernel behind the C entry point ``entry`` the card runs at once."""
    from . import build

    return getattr(build.library(), entry)(cluster, smem)

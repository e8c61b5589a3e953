"""Process groups and block-sharded execution of the simulation.

Counterpart of ``demiurge_tpu/dist/mesh.py``.  The lat-lon grid is split
over a 2-D mesh of processes, ``ny`` latitude bands ('y') by ``nx``
longitude sectors ('x'); process (yi, xi) is rank yi*nx + xi and holds the
(H/ny, W/nx) block of every field at rows yi*H/ny and columns xi*W/nx, the
layout ``P('y', 'x')`` gives in JAX.  One process drives one device.

Two execution paths, as in the reference:

- the explicit paths in ``dist.local`` (the stencil stages: GSPMD's
  partitioning written out), ``dist.halo``, ``dist.flowdist``,
  ``dist.climate`` and ``dist.advect``: halo exchanges by paired
  ``isend``/``irecv`` and row regroups by ``all_to_all_single``, for
  every option on any x-periodic grid;
- ``sharded_call``, kept for what has no local form (its docstring): it
  gathers the block arguments, runs the unmodified single-device op and
  returns this rank's block of each output.  Exact, since it is the same
  code; not communication-local.

``initialize`` joins the process group: from torchrun's environment, or a
one-process group when there is none.  NCCL for CUDA tensors, gloo for CPU
tensors (``core.platform.collective_backend``).

Traffic counters: ``TRAFFIC`` holds the bytes this rank received from
other ranks, by kind of collective ("gather_field", the full fields of
``gather_field`` and ``sharded_call``; "permute", the halo exchanges;
"all_to_all", the row regroups; "all_gather_rows"; "all_reduce"), and
``CALLS`` the calls of ``sharded_call`` and ``gather_field`` ("field
gathers", one a gathered argument).  ``reset_traffic`` zeroes both,
``traffic`` reads them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core.platform import claim_rank_device, collective_backend

#: bytes received from other ranks, by kind (module docstring)
TRAFFIC = {"gather_field": 0, "permute": 0, "all_to_all": 0,
           "all_gather_rows": 0, "all_reduce": 0}
#: calls of ``sharded_call``, and full-field gathers
CALLS = {"sharded_call": 0, "field_gathers": 0}


def reset_traffic() -> None:
    for d in (TRAFFIC, CALLS):
        for key in d:
            d[key] = 0


def traffic() -> dict:
    """The counters: {"bytes": TRAFFIC, **CALLS}, copied."""
    return {"bytes": dict(TRAFFIC), **CALLS}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the (ny, nx) mesh, its device, and the
    group of its mesh row (along 'x').  Collectives over every rank use
    the default group."""

    ny: int
    nx: int
    yi: int
    xi: int
    device: torch.device
    row_group: object

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def size(self) -> int:
        return self.ny * self.nx

    @property
    def rank(self) -> int:
        return self.yi * self.nx + self.xi

    def rank_of(self, yi: int, xi: int) -> int:
        return yi * self.nx + xi


def initialize(device="cuda") -> torch.device:
    """Join the process group (once) and return this process's device.
    Under torchrun (RANK, WORLD_SIZE, MASTER_ADDR in the environment) the
    group is torchrun's; without it, a group of this one process over an
    in-process store."""
    device = claim_rank_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        backend = collective_backend(device)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    return device


def choose_mesh_shape(n: int) -> Tuple[int, int]:
    """Factor n into (ny, nx), near-square with nx >= ny (the x ring
    carries the E/W exchanges, which dominate)."""
    best = (1, n)
    for ny in range(1, int(math.isqrt(n)) + 1):
        if n % ny == 0:
            best = (ny, n // ny)
    return best


def make_mesh(shape: Optional[Tuple[int, int]] = None, *, device) -> Mesh:
    """The (ny, nx) mesh over every rank of the process group (which must
    exist: ``initialize``), driving ``device`` (what ``initialize``
    returned); ``shape`` defaults to ``choose_mesh_shape``.  Every rank
    calls this, in the same order as any other group creation."""
    n = dist.get_world_size()
    ny, nx = shape if shape is not None else choose_mesh_shape(n)
    if ny * nx != n:
        raise ValueError(f"mesh {ny}x{nx} is not the group's {n} ranks")
    yi, xi = divmod(dist.get_rank(), nx)
    row_group = None
    for y in range(ny):  # every rank creates every group, in one order
        g = dist.new_group([y * nx + x for x in range(nx)])
        row_group = g if y == yi else row_group
    mesh = Mesh(ny, nx, yi, xi, torch.device(device), row_group)
    # a first collective with every rank, before any point-to-point call
    dist.all_reduce(torch.zeros(1, device=mesh.device))
    return mesh


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def block_shape(shape, mesh: Mesh) -> Tuple[int, int]:
    H, W = shape
    if H % mesh.ny or W % mesh.nx:
        raise ValueError(f"grid {W}x{H} does not split over mesh "
                         f"{mesh.ny}x{mesh.nx}")
    return H // mesh.ny, W // mesh.nx


def local_part(x: torch.Tensor, shape, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a full-grid tensor: its rows where ``x`` spans
    the grid's H rows, its columns where it spans the W columns (so an
    (H, W) field gives the block, an (H, 1) table the block's rows, a
    (1, W) table its columns)."""
    H, W = shape
    h, w = block_shape(shape, mesh)
    if x.dim() >= 2 and x.shape[-2] == H:
        x = x[..., mesh.yi * h:(mesh.yi + 1) * h, :]
    if x.dim() >= 1 and x.shape[-1] == W:
        x = x[..., mesh.xi * w:(mesh.xi + 1) * w]
    return x.contiguous()


def shard_field(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A full (H, W) field -> this rank's block."""
    return local_part(x, tuple(x.shape), mesh)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Collectives carry bool as uint8."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()


def gather_field(block: torch.Tensor, mesh: Mesh,
                 dst: Optional[int] = None) -> Optional[torch.Tensor]:
    """Every rank's (h, w) block -> the full (ny*h, nx*w) field: on every
    rank, or with ``dst`` on that rank only (the others get None)."""
    wire = _wire(block)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    CALLS["field_gathers"] += 1
    if dst is None:
        dist.all_gather(parts, wire)
    else:
        dist.gather(wire, parts if mesh.rank == dst else None, dst=dst)
        if mesh.rank != dst:
            return None
    TRAFFIC["gather_field"] += (mesh.size - 1) * _nbytes(wire)
    rows = [torch.cat(parts[y * mesh.nx:(y + 1) * mesh.nx], dim=1)
            for y in range(mesh.ny)]
    return torch.cat(rows, dim=0).to(block.dtype)


def row_groups(H: int, mesh: Mesh) -> Tuple[int, ...]:
    """The first grid row of every rank's row group, and H: rank (yi, xi)
    holds rows [starts[g], starts[g + 1]) of mesh row yi's block, split
    over its nx ranks as evenly as the rows allow (rank g of the even
    layout holds rows [g*r, (g+1)*r), r = H / (ny*nx))."""
    h = H // mesh.ny
    return tuple(y * h + x * h // mesh.nx for y in range(mesh.ny)
                 for x in range(mesh.nx)) + (H,)


def row_group(H: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's row group: (first row, row after the last)."""
    starts = row_groups(H, mesh)
    return starts[mesh.rank], starts[mesh.rank + 1]


def _row_splits(h: int, nx: int):
    return [(x + 1) * h // nx - x * h // nx for x in range(nx)]


def blocks_to_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(h, w) blocks -> full-width row groups (r, W) over the mesh row:
    rank (yi, xi) gets mesh row yi's rows of its group (``row_group``)
    (JAX's all_to_all along 'x', split rows, concatenate columns)."""
    if mesh.nx == 1:
        return x
    splits = _row_splits(x.shape[0], mesh.nx)
    r = splits[mesh.xi]
    out = x.new_empty((mesh.nx * r, x.shape[1]))
    dist.all_to_all_single(out, x.contiguous(), [r] * mesh.nx, splits,
                           group=mesh.row_group)
    TRAFFIC["all_to_all"] += _nbytes(out) * (mesh.nx - 1) // mesh.nx
    return out.reshape(mesh.nx, r, -1).permute(1, 0, 2).reshape(r, -1)


def rows_to_blocks(x: torch.Tensor, mesh: Mesh, height: int) -> torch.Tensor:
    """The inverse of ``blocks_to_rows``; ``height`` is the grid's H
    (the row groups of a mesh row may differ by a row)."""
    if mesh.nx == 1:
        return x
    r, W = x.shape
    h = height // mesh.ny
    w = W // mesh.nx
    chunks = x.reshape(r, mesh.nx, w).permute(1, 0, 2).reshape(-1, w)
    out = x.new_empty((h, w))
    dist.all_to_all_single(out, chunks.contiguous(),
                           _row_splits(h, mesh.nx), [r] * mesh.nx,
                           group=mesh.row_group)
    TRAFFIC["all_to_all"] += _nbytes(out) - r * w * x.element_size()
    return out


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (r, W) rows stacked in rank order, on every rank."""
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire)
    TRAFFIC["all_gather_rows"] += (mesh.size - 1) * _nbytes(wire)
    return torch.cat(parts, dim=0).to(x.dtype)


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or its maximum, ``op="max"``) over every rank, on
    every rank (a new tensor)."""
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    if mesh.size > 1:
        TRAFFIC["all_reduce"] += _nbytes(t)
    return t


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` holds on any rank (JAX's pmax over both axes)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if mesh.size > 1:
        TRAFFIC["all_reduce"] += _nbytes(t)
    return bool(t.item())


# ---------------------------------------------------------------------------
# the GSPMD stand-in
# ---------------------------------------------------------------------------


def _map_outputs(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_map_outputs(o, fn) for o in out)
    return out


def sharded_call(fn, mesh: Mesh):
    """Run the single-device op ``fn`` under ``mesh``: every 2-D tensor
    argument is a block and is gathered into its full field, ``fn`` runs
    on the full fields (every rank the same work), and each tensor output
    comes back as this rank's part (``local_part``).

    What still runs so, and why:

    - the advect's bilinear sampler of ``advect_method="exact"``, and the
      advect on a grid that is not x-periodic: it fetches at
      data-dependent points, which the reference's partitioner cannot keep
      local either (its ``sample_bilinear`` gathers);
    - every stage on a grid that does not wrap in x (regional): the halo
      exchange always wraps its columns (``dist.halo._source``), a
      ``core.grid.Window``'s shifts roll them, and the reference's halo
      solvers take x-periodic grids only; no CLI command builds such a
      grid.  Its local form is the next item of the port's roadmap."""

    def call(*args, **kwargs):
        CALLS["sharded_call"] += 1
        full = []

        def gather(a):
            if isinstance(a, torch.Tensor) and a.dim() == 2:
                a = gather_field(a, mesh)
                full.append(tuple(a.shape))
            return a

        args = [gather(a) for a in args]
        kwargs = {k: gather(v) for k, v in kwargs.items()}
        if not full:
            raise ValueError("sharded_call needs a 2-D block argument")
        out = fn(*args, **kwargs)
        return _map_outputs(out, lambda t: local_part(t, full[0], mesh))

    return call

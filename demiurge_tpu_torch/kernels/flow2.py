"""Two-level flow accumulation: band-local fixpoints + a contracted
inter-band drainage graph.

Counterpart of ``demiurge_tpu/pallas_kernels/flow2.py``.  D8 flow is a
forest, so mass injected anywhere in a band of rows follows one in-band
path and leaves the band through at most one crossing edge.  The solve is

  1. every band's local fixpoint (``flow_local_solve``, K10a): A_loc, the
     upstream sums from in-band sources only (``mask_local`` clears the
     incoming bits that reach across a band edge), and E, the id of the
     crossing edge a cell's in-band path leaves through (-1 if it ends in
     the band);
  2. the coarse graph on the bands' first and last rows
     (``coarse_graph_rows``): each crossing edge s has one successor, the
     next crossing its mass reaches, and its own mass A_loc[s]; the chain
     sums X come from pointer doubling (``_accumulate_adaptive``);
  3. X delivered at each crossing target as extra area, and the band-local
     solve again, warm-started at A_loc + inj.

By linearity the result is the global fixpoint; the chain sums reassociate
f32 additions, so A equals ``ops.flow.flow_solve_stencil``'s within f32
rounding, not bit for bit.  The reachability half (``flow_local_vis``,
K10b, and ``_or_chain_adaptive``) serves the sharded solve in
``dist.flowdist``.

``flow_local_solve`` / ``flow_local_vis`` launch the CUDA kernels
(``csrc/flow.cu``) for CUDA tensors and run the plain twins (the port of
the reference's XLA twins: all bands sweep together on a (nbands, band, W)
stack) for CPU tensors.  Exit ids are int32 here (float32 in the
reference; ids < 2W are exact in both).  ``LAUNCHES_LOCAL`` /
``LAUNCHES_LOCAL_VIS`` count kernel launches (one per sweep);
``LAST_SOLVE`` holds the last CUDA solve's sweeps and host reads.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.platform import check_kernel_inputs, use_cuda_kernels
from ..core.topology import NEIGHBORS_FLOW_ORDER, shift
from .flow import pack_masks, solve_rounds_cuda

LAUNCHES_LOCAL = 0
LAUNCHES_LOCAL_VIS = 0
LAST_SOLVE: dict = {}

MAX_SWEEPS = 1 << 20

# indices into NEIGHBORS_FLOW_ORDER by the offset of the neighbour
_DY_POS = tuple(i for i, (_, dy) in enumerate(NEIGHBORS_FLOW_ORDER) if dy > 0)
_DY_NEG = tuple(i for i, (_, dy) in enumerate(NEIGHBORS_FLOW_ORDER) if dy < 0)
_DX_POS = tuple(i for i, (dx, _) in enumerate(NEIGHBORS_FLOW_ORDER) if dx > 0)
_DX_NEG = tuple(i for i, (dx, _) in enumerate(NEIGHBORS_FLOW_ORDER) if dx < 0)


def _mask(indices, first: int = 0) -> int:
    return sum(1 << (first + i) for i in indices)


def pick_band(H: int) -> int:
    """The single-card band height (the reference's ``_pick_band``)."""
    for band in (128, 64, 32):
        if H % band == 0:
            return band
    return 0


def mask_local(packed, band: int) -> torch.Tensor:
    """Clear the incoming bits that reach across a band edge: a band's
    first row drops its dy = -1 bits, its last row its dy = +1 bits."""
    rl = torch.arange(packed.shape[0], device=packed.device).reshape(-1, 1) \
        % band
    packed = torch.where(rl == 0, packed & ~_mask(_DY_NEG), packed)
    return torch.where(rl == band - 1, packed & ~_mask(_DY_POS), packed)


def _local_layout(packed, band: int):
    """(outgoing bits, crossing flags, self ids) on the (nbands, band, W)
    stack."""
    H, W = packed.shape
    p3 = packed.reshape(H // band, band, W)
    outs = [((p3 >> (8 + i)) & 1).bool() for i in range(8)]
    rl = torch.arange(band, device=packed.device).reshape(1, -1, 1)
    col = torch.arange(W, device=packed.device).reshape(1, 1, -1)
    crossing = ((rl == 0) & ((p3 & _mask(_DY_NEG, 8)) != 0)) \
        | ((rl == band - 1) & ((p3 & _mask(_DY_POS, 8)) != 0))
    selfid = torch.where(rl == 0, col, W + col).to(torch.int32)
    return p3, outs, crossing, selfid


def _band_roll(x, dx: int, dy: int):
    """x[b, r + dy, c + dx] on the (nbands, band, W) stack, band-circular
    in r (the reads that wrap are masked off by the caller's bits)."""
    x = torch.roll(x, -dy, dims=1) if dy else x
    return torch.roll(x, -dx, dims=2) if dx else x


def flow_local_solve_plain(packed_local, area2d, a0, band: int,
                           with_exit: bool = True,
                           max_sweeps: int = MAX_SWEEPS):
    """Plain twin of ``flow_local_solve``: Jacobi sweeps of every band
    together until a sweep changes nothing."""
    H, W = packed_local.shape
    p3, outs, crossing, selfid = _local_layout(packed_local, band)
    inc = [((p3 >> i) & 1).bool() for i in range(8)]
    area3 = area2d.reshape(p3.shape)
    A = a0.reshape(p3.shape)
    E = torch.where(crossing, selfid, -1) if with_exit else None
    for _ in range(max_sweeps):
        newA = area3
        for ok, (dx, dy) in zip(inc, NEIGHBORS_FLOW_ORDER):
            newA = newA + torch.where(ok, _band_roll(A, dx, dy), 0.0)
        same = torch.equal(newA.view(torch.int32), A.view(torch.int32))
        A = newA
        if with_exit:
            newE = torch.full_like(E, -1)
            for m, (dx, dy) in zip(outs, NEIGHBORS_FLOW_ORDER):
                newE = torch.where(m, _band_roll(E, dx, dy), newE)
            newE = torch.where(crossing, selfid, newE)
            same = same and torch.equal(newE, E)
            E = newE
        if same:
            return A.reshape(H, W), (E.reshape(H, W) if with_exit else None)
    raise RuntimeError("band-local flow relaxation did not converge")


def flow_local_vis_plain(packed_local, seed, band: int,
                         max_sweeps: int = MAX_SWEEPS) -> torch.Tensor:
    """Plain twin of ``flow_local_vis``: float 0/1."""
    H, W = packed_local.shape
    p3, outs, crossing, _ = _local_layout(packed_local, band)
    seedm = torch.maximum(((p3 >> 16) & 1).to(torch.float32),
                          seed.reshape(p3.shape))
    vis = seedm
    for _ in range(max_sweeps):
        new = seedm
        for m, (dx, dy) in zip(outs, NEIGHBORS_FLOW_ORDER):
            new = torch.maximum(new, torch.where(m, _band_roll(vis, dx, dy),
                                                 0.0))
        new = torch.where(crossing, seedm, new)
        if torch.equal(new, vis):
            return vis.reshape(H, W)
        vis = new
    raise RuntimeError("band-local vis relaxation did not converge")


def _check_band(shape, band: int) -> None:
    if band < 1 or shape[0] % band != 0:
        raise ValueError(f"band {band} does not divide {shape[0]} rows")


def flow_local_solve_cuda(packed_local, area2d, a0, band: int,
                          with_exit: bool = True):
    """K10a on the card: in-place sweeps on a copy of ``a0`` (and on exit
    ids from -1), in K7's certified rounds."""
    global LAUNCHES_LOCAL
    shape = tuple(packed_local.shape)
    check_kernel_inputs(("packed_local",), (packed_local,), shape=shape,
                        dtype=torch.int32)
    check_kernel_inputs(("area2d", "a0"), (area2d, a0), shape=shape)
    _check_band(shape, band)
    H, W = shape
    A = a0.clone()
    E = torch.full(shape, -1, dtype=torch.int32, device=A.device) \
        if with_exit else None
    stream = torch.cuda.current_stream(A.device).cuda_stream
    stats = solve_rounds_cuda(
        "demiurge_flow_local_sweeps",
        lambda flags, n: (packed_local.data_ptr(), area2d.data_ptr(),
                          A.data_ptr(), None if E is None else E.data_ptr(),
                          flags, H, W, band, n, stream),
        A.device, band * W + 1)
    LAUNCHES_LOCAL += stats["launched"]
    LAST_SOLVE["A"] = stats
    return A, E


def flow_local_vis_cuda(packed_local, seed, band: int) -> torch.Tensor:
    """K10b on the card: one byte a pixel from max(mouth, seed) (seed is
    0/1), in K7's certified rounds.  Returns float 0/1."""
    global LAUNCHES_LOCAL_VIS
    shape = tuple(packed_local.shape)
    check_kernel_inputs(("packed_local",), (packed_local,), shape=shape,
                        dtype=torch.int32)
    check_kernel_inputs(("seed",), (seed,), shape=shape)
    _check_band(shape, band)
    H, W = shape
    vis = (((packed_local >> 16) & 1) | (seed != 0).to(torch.int32)).to(
        torch.uint8)
    stream = torch.cuda.current_stream(vis.device).cuda_stream
    stats = solve_rounds_cuda(
        "demiurge_flow_local_vis_sweeps",
        lambda flags, n: (packed_local.data_ptr(), vis.data_ptr(), flags, H,
                          W, band, n, stream),
        vis.device, band * W + 1)
    LAUNCHES_LOCAL_VIS += stats["launched"]
    LAST_SOLVE["vis"] = stats
    return vis.to(torch.float32)


def flow_local_solve(packed_local, area2d, a0, band: int,
                     with_exit: bool = True):
    """Band-local fixpoint of the A relaxation (and the exit ids): the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors.  Returns
    (A, E), E None when ``with_exit`` is False."""
    if use_cuda_kernels(packed_local, area2d, a0):
        return flow_local_solve_cuda(packed_local, area2d, a0, band,
                                     with_exit)
    return flow_local_solve_plain(packed_local, area2d, a0, band, with_exit)


def flow_local_vis(packed_local, seed, band: int) -> torch.Tensor:
    """Band-local mouth reachability from ``seed``: vis flows upstream,
    crossing cells hold max(mouth, seed) (their continuation comes from
    the coarse chain).  The CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors.  Returns float 0/1."""
    if use_cuda_kernels(packed_local, seed):
        return flow_local_vis_cuda(packed_local, seed, band)
    return flow_local_vis_plain(packed_local, seed, band)


# ---------------------------------------------------------------------------
# the coarse graph (small: two rows a band), plain torch on either device
# ---------------------------------------------------------------------------


def _or_chain_adaptive(succ, n0, max_rounds: int = 48):
    """Suffix-OR along the functional graph: out[s] = max of n0 over s,
    succ(s), succ^2(s), ... (-1 ends a chain), by pointer doubling."""
    alive = succ >= 0
    ptr = torch.where(alive, succ, 0)
    X = n0
    for _ in range(max_rounds):
        if not bool(alive.any()):
            break
        X = torch.where(alive, torch.maximum(X, X[ptr]), X)
        nxt = alive & alive[ptr]
        ptr = torch.where(nxt, ptr[ptr], ptr)
        alive = nxt
    return X


def _accumulate_adaptive(parent, m0, max_rounds: int = 48):
    """X[s] = m0[s] + the sum of m0 over every chain predecessor of s in
    the functional graph ``parent`` (-1 = chain end), by pointer doubling
    until no pointer is alive (the graph is acyclic).  On CUDA the
    scatter-add runs in atomics, so sums into one target may round in
    another order from run to run."""
    N = parent.shape[0]
    alive = parent >= 0
    ptr = torch.where(alive, parent, 0)
    X = m0
    for _ in range(max_rounds):
        if not bool(alive.any()):
            break
        contrib = torch.where(alive, X, 0.0)
        tgt = torch.where(alive, ptr, N)  # N = the drop bucket
        # scatter-added into X itself, in update order: the form XLA
        # compiles the reference's X + zeros.at[tgt].add(...) into, so the
        # CPU sums equal the reference's bit for bit
        Xd = torch.cat([X, X.new_zeros(1)])
        X = Xd.index_add_(0, tgt, contrib)[:N]
        nxt = alive & alive[ptr]
        ptr = torch.where(nxt, ptr[ptr], ptr)
        alive = nxt
    return X


def coarse_rows(x, band: int) -> torch.Tensor:
    """(H, W) -> (2*nbands, W): row 2b = first row of band b, 2b+1 = its
    last."""
    H, W = x.shape
    xr = x.reshape(H // band, band, W)
    return torch.stack([xr[:, 0], xr[:, -1]], dim=1).reshape(-1, W)


def coarse_graph(packed, A_loc, E, band: int):
    """The contracted inter-band drainage graph from full-grid phase-1
    output (see ``coarse_graph_rows``)."""
    return coarse_graph_rows(coarse_rows(packed, band),
                             coarse_rows(A_loc, band),
                             coarse_rows(E, band), band)


def coarse_graph_rows(pc, Ac, Ec, band: int):
    """The inter-band drainage graph from the stacked boundary rows
    (2*nbands, W): pc the packed masks, Ac the band-local A, Ec the local
    exit ids.

    Returns (succ, m0, tflat_c, tflat_g, srcflat_g, cross), flat over
    (2*nbands*W,): succ the next crossing edge (-1 = chain end), m0 the
    band-local mass at the crossing source, tflat_c / tflat_g the coarse /
    global flat index the mass is delivered at (H*W = drop), srcflat_g the
    crossing source's own global index, cross which coarse cells are
    crossing sources."""
    nbands2, W = pc.shape
    nbands = nbands2 // 2
    H = nbands * band
    dev = pc.device
    Ec = Ec.to(torch.int32)

    rows2 = torch.arange(nbands2, device=dev).reshape(-1, 1)
    is_first = rows2 % 2 == 0
    b_idx = rows2 // 2

    def any_out(indices):
        return (pc & _mask(indices, 8)) != 0

    cross_dn = any_out(_DY_POS) & ~is_first
    cross_up = any_out(_DY_NEG) & is_first
    cross = cross_dn | cross_up
    # dx of the (unique) out direction
    dx = any_out(_DX_POS).to(torch.int64) - any_out(_DX_NEG).to(torch.int64)

    col = torch.arange(W, device=dev).reshape(1, -1)
    tcol = torch.remainder(col + dx, W)
    # crossing down lands on the first row of band b+1 (coarse row 2(b+1)),
    # crossing up on the last row of band b-1 (coarse row 2(b-1)+1)
    trow_c = torch.where(cross_dn, 2 * (b_idx + 1), 2 * (b_idx - 1) + 1)
    trow_c = torch.clamp(trow_c, 0, nbands2 - 1)  # inert where ~cross
    tflat_c = trow_c * W + tcol

    # local exit ids (side*W + col in the holding band) -> coarse layout
    Eg = torch.where(Ec >= 0, (2 * b_idx + Ec // W) * W + Ec % W, -1)

    succ = torch.where(cross, Eg.reshape(-1)[tflat_c.reshape(-1)]
                       .reshape(nbands2, W), -1)
    m0 = torch.where(cross, Ac, 0.0)

    trow_g = torch.where(cross_dn, (b_idx + 1) * band, b_idx * band - 1)
    tflat_g = torch.where(cross, trow_g * W + tcol, H * W)

    srow_g = torch.where(is_first, b_idx * band, (b_idx + 1) * band - 1)
    srcflat_g = torch.where(cross, srow_g * W + col, H * W)

    return (succ.reshape(-1), m0.reshape(-1), tflat_c.reshape(-1),
            tflat_g.reshape(-1), srcflat_g.reshape(-1), cross.reshape(-1))


def flow_twolevel_supported(grid: Grid, band: int = 0) -> bool:
    band = band or pick_band(grid.height)
    return bool(grid.wrap_x and band)


def flow_solve_twolevel(code, area2d, mouth, grid: Grid, band: int = 0
                        ) -> torch.Tensor:
    """The A half of the flow accumulation by the two-level scheme (module
    docstring): ``flow_solve_area``'s fixpoint within f32 summation
    order."""
    H, W = grid.shape
    band = band or pick_band(H)
    if not (band and H % band == 0 and grid.wrap_x):
        raise ValueError(f"two-level solve needs an x-periodic grid and a "
                         f"band dividing H: {grid.shape}, band {band}")
    nbands = H // band
    packed = pack_masks(code, mouth, grid)
    ploc = mask_local(packed, band)
    A_loc, E = flow_local_solve(ploc, area2d, area2d, band,
                                with_exit=nbands > 1)
    if nbands == 1:
        return A_loc

    succ, m0, _, tflat_g, _, cross = coarse_graph(packed, A_loc, E, band)
    X = _accumulate_adaptive(succ, m0)
    inj = torch.zeros(H * W + 1, dtype=torch.float32, device=area2d.device)
    inj = inj.index_add_(0, tflat_g, torch.where(cross, X, 0.0))[:H * W]
    inj = inj.reshape(H, W)
    A, _ = flow_local_solve(ploc, area2d + inj, A_loc + inj, band,
                            with_exit=False)
    return A

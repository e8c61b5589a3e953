// K12: the lake-aware flow relaxation, for Hopper (sm_90a): its fixpoint
// solved on K7/K8's shared-memory tiles in certified rounds, with the lake
// connections waking the tiles they reach; and the one-sweep-a-launch
// kernel it replaced, kept as the yardstick.
//
// Replaces the device loop that demiurge_tpu/ops/flow.py flow_solve_stencil
// (:342-432, sweep :385) compiles: XLA's fused 8-neighbour stencil with
// the lake connections' scatter in the same loop (no Pallas kernel behind
// it).  The port ran it as some 110 torch launches a sweep
// (kernels/lakeflow.py relax_sweep_twin, the plain twin).
//
// The fixpoint, per cell p = (y, x) (the twin's Jacobi sweep, iterated):
//   A[p]    = area[p] + A[nbr_i] for each incoming bit i (bits 0..7 of
//             packed) in NEIGHBORS_FLOW_ORDER, by __fadd_rn, left to
//             right; then + A[conn_src[p]] where bit 18 is set (the
//             twin's connection add comes after its taps)
//   vis[p]  = mouth (bit 16) | vis[nbr] of the outgoing bit (bits 8..15,
//             one-hot) | vis[conn_dst[p]] where bit 19 is set
//   root[p] = p at a sink (bit 17), else root[nbr] of the outgoing bit,
//             else -1 (connections do not carry root)
// with nbr_i = core/topology.py shift(pole_wrap=False)'s neighbour: row
// clamp(y + dy_i), column (x + dx_i) mod W on an x-periodic grid and
// clamp(x + dx_i) on any other.  On a global grid the masks already drop
// rows beyond it (kernels/flow.py pack_masks), so the clamp only acts
// where the twin's shift clamps too.  The twin adds +0.0 where a bit is
// clear; skipping it is exact, since A is a sum of non-negative areas.
// There are no products, so nothing can contract into an fma.
// conn_src and conn_dst (-1 where a cell has no connection) are read only
// where bits 18 and 19 say they hold one.  The flow graph with the
// connections (lake sink -> attach pixel) is acyclic, so each fixpoint is
// unique: A is the twin's bit for bit, vis and root exactly, whatever the
// schedule.
//
// Why the tiles, and why here.  A Jacobi sweep moves a path's front one
// cell, so the one-sweep kernel (lake_relax_sweep, below) took as many
// launches as the longest path through the merged lakes (704 sweeps at
// 1024x512, up to 1472 at 2048x1024), each moving 26 B a cell.  The
// redesign is K7/K8's (csrc/flow.cu, whose header has the design and the
// stale-halo argument), sharing its tile load, edge bits, passes and
// round launcher (csrc/flow_tiles.cuh).  The three fields are three
// kernels here, beside the one-sweep kernel that computes the same
// fixpoint, rather than modes of K7's and K8's kernels: each differs from
// its K7/K8 model in the neighbour (clamped where the grid does not wrap),
// the connections and the waking, and K7/K8 stay as they were.  A reads
// neither vis nor root, and each is certified on its own, so the host runs
// the three solves side by side in one batch loop (kernels/flow.py
// solve_tiles_cuda), each on its own stream: a round of a few awake tiles
// lasts one visit and leaves the card nearly idle, so their rounds
// overlap.
//   - lake_area_tile_kernel: K7's visit (strips of 32 columns relaxed in
//     passes over their dirty rows), the taps at the clamped neighbours,
//     then + A[conn_src[p]] at an attach pixel (bit 18).  Where the lake
//     sink lies in the tile (most connections: a sink and the pass out of
//     its lake are near), the term reads the sink's cell in shared memory,
//     and a change of the sink marks the attach pixel's row dirty in its
//     strip (relax's `extra` marks); where it lies in another tile, the
//     term is read at the visit's start, like a halo cell.  After round 0
//     a visit starts with only the rows whose inputs may have changed
//     dirty: next to the halo cells that the neighbours' edge bits say
//     were written, in the strips that read them, and the rows of the
//     attach pixels read remotely where the wake word is set (a row that
//     is not dirty satisfies its equations, as in K7's passes);
//   - lake_vis_tile_kernel: K8's pointer jumping.  A cell with bit 19 (a
//     lake sink: no out bit) has one outgoing edge, its connection's
//     attach pixel conn_dst[p]: in the tile it points there; in another
//     tile it is an end whose value is mouth | vis[conn_dst[p]] read at
//     the visit's start (vis only turns 0 -> 1, and a cell turns to 1 only
//     from a 1 on its path, so the remote value ORed in before the passes
//     is all the walk needs);
//   - lake_root_tile_kernel: K10a's exit-id pointer jumping (csrc/flow.cu
//     exit_tile_kernel) with other ends: a sink at its own flat index, a
//     cell without an out bit at -1, a halo cell (and a cell that points
//     at itself through a clamp) at root as loaded; every cell then takes
//     its end's value, and the cells that differ are written back.
// Waking.  K7's 8 edge bits, plus a wake word a tile (after the edge bits
// in the flags, ping-ponged like them, cleared by its tile when read): a
// visit that writes A at a cell with bit 19 sets kRemote in the word of
// the tile of conn_dst[p] (the attach pixel that reads it), and a visit
// that writes vis at a cell with bit 18 in the word of the tile of
// conn_src[p] (the sink that reads it), for the next round, where that
// tile is another one (a connection within a tile is solved in the
// visit).
//
// Why the stale reads are sound (csrc/flow.cu's argument, with remote
// cells).  A visit reads, besides its halo, one remote cell for each
// connection end its tile holds whose other end lies in another tile:
// A[conn_src[p]] or vis[conn_dst[p]], at its start, through L2 (__ldcg),
// and holds it for the visit, as it holds its halo.  Every write of a cell
// that another tile reads remotely sets that tile's wake word for the next
// round, in the same round as the write, and marks the round as one that
// wrote.  Claim: at the end of round t, every tile not woken for round
// t+1 (no cell of its halo and no cell it reads remotely was written in
// round t) satisfies its equations.  If it ran in round t, it solved
// against a halo and remote values that held to the end of the round (a
// value read before another tile wrote it in the same round wakes the
// tile for t+1), and its connections within the tile are equations of its
// local fixpoint like its taps; if it did not run, it satisfied its
// equations at the end of round t-1 and nothing it reads changed since
// (induction; round 0 runs every tile).  So a round in which no tile
// wrote leaves no wake word set and every cell satisfied: the global
// fixpoint.  The same induction gives A's starting rows: a tile woken for
// round t+1 satisfied its equations at the end of round t against what it
// read then, so only the rows that read a cell written in round t (the
// halo cells its edge bits name, the remote cells its wake word names)
// can fail them.  The solve stops at the first round in which none of A,
// vis and root was written; each is certified by its own rounds.  The
// passes a visit are capped as in K7 and K8, so a launch ends even on
// masks with a cycle; the host then finds no certifying round within its
// limit and raises.
//
// Bound on this card: device-memory bytes.  The solve must read packed
// and area (4 B each) and write A (4), vis (1) and root (4) once: 17 B a
// cell, 0.0107 ms at 2048x1024 with the connection lists (16 B a
// connection); a kernel alone: A 12 B a cell (packed, area, A), vis 5,
// root 8, each with what it reads of the lists; at most 9 adds a cell.
// What limits it is latency: a solve takes as many rounds as the tile
// edges and cross-tile connections its longest path crosses (about 50 at
// 2048x1024), each round at least one visit long, and a visit of A as
// long as its passes over its dirty rows.
//
// The one-sweep kernel (the earlier design, off every user path): one
// thread a cell, a block a 256-column piece of one row (x masked where 256
// does not divide W), one launch a sweep, the sweeps of a call launched
// back to back on the caller's stream over two ping-pong sets.  A sweep
// must move packed, area, A, root (4 B each) and vis (1 B) read and A,
// vis, root written: 26 B a cell, plus the connection lists.

#include "flow_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSinkBit = 1 << 17;
constexpr int kSrcBit = 1 << 18;
constexpr int kDstBit = 1 << 19;

// ---------------------------------------------------------------------------
// The tiled solve.
// ---------------------------------------------------------------------------

// K12's meta bits beside K7's (bits 0..7 incoming, kFeed, kReal)
constexpr int kAttach = 1 << 10;  // bit 18: + A[conn_src] after the taps

// a wake word's bit: a cell this tile reads remotely was written
constexpr int kRemote = 1 << 8;

// the tile-local slot of cell (li, t)'s neighbour along bit k: the row
// clamped to the grid, the column wrapped (into the halo) or clamped
template <int TY, int TX>
__device__ __forceinline__ int nbr_slot(int li, int t, int k, int r0,
                                        int c0, int H, int W, bool wrap_x) {
  const int r = min(max(r0 + li + dyk(k), 0), H - 1);
  int c = c0 + t + dxk(k);
  if (!wrap_x) c = min(max(c, 0), W - 1);
  return (r - r0 + 1) * (TX + 2) + c - c0 + 1;
}

// the tile that holds flat cell g
template <int TY, int TX>
__device__ __forceinline__ int tile_of(int g, int W, int nbx) {
  const int r = g / W;
  return (r / TY) * nbx + (g - r * W) / TX;
}

// a change of this cell feeds its own row: an out bit whose (clamped)
// target lies in the cell's row
__device__ __forceinline__ bool feeds_row(int out, int r, int H) {
  return (out & kRowOut) || (r == 0 && (out & kNegOut)) ||
         (r == H - 1 && (out & kPosOut));
}

template <int TY, int TX>
constexpr size_t lake_area_smem() {
  return sizeof(float) * ((TY + 2) * (TX + 2) + 2 * TY * TX) +
         3 * sizeof(int16_t) * TY * TX;
}

template <int TY, int TX>
constexpr size_t lake_vis_smem() {
  return ((TY + 2) * (TX + 2) + 15) / 16 * 16 +
         sizeof(int16_t) * (TY + 2) * (TX + 2);
}

template <int TY, int TX>
constexpr size_t lake_root_smem() {
  return (sizeof(int) + sizeof(int16_t)) * (TY + 2) * (TX + 2);
}

// the tile cell of flat cell g, by its row and column in tile (r0, c0)
template <int TX>
__device__ __forceinline__ int tile_cell(int g, int r0, int c0, int W) {
  const int r = g / W;
  return (r - r0) * TX + g - r * W - c0;
}

// A visit's reads of its own cells (and through them of the connections'
// other ends) are issued at once, in unrolled loops, before it uses any of
// them, and the write-back compares with the values read at the start
// (only this block writes its cells), so it reads nothing again.
//
// prev, cur: this round's and the next round's edge bits; the wake words
// follow each at + 2 * nt (tile_rounds' layout)
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    lake_area_tile_kernel(const int* __restrict__ packed,
                          const float* __restrict__ area,
                          const int* __restrict__ conn_src,
                          const int* __restrict__ conn_dst, float* A,
                          int wrap_x, int* prev, int* cur, int* stats,
                          int slot, int H, int W, int nby, int nbx) {
  constexpr int SW = TX + 2, NW = TX / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  __shared__ unsigned long long links[NW];  // rows an in-tile sink woke
  volatile float* sA = reinterpret_cast<float*>(smem);
  float* sArea = reinterpret_cast<float*>(smem) + (TY + 2) * SW;
  float* sConn = sArea + TY * TX;
  uint16_t* sMeta = reinterpret_cast<uint16_t*>(sConn + TY * TX);
  int16_t* sSrc = reinterpret_cast<int16_t*>(sMeta + TY * TX);
  int16_t* sDst = sSrc + TY * TX;
  const int nt = nby * nbx;
  const int woke = tile_awake(prev, cur, nby, nbx, &out, prev + 2 * nt);
  if (!woke) return;

  const int t = threadIdx.x;
  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX, c = c0 + t;
  const bool wrap = wrap_x != 0;
  const bool cold = prev[blockIdx.x] == -1;  // round 0 (the flags' start)
  if (t < NW) links[t] = 0;
  load_halo<TY, TX>(sA, A, r0, c0, H, W);
  int pk[TY], src[TY], dst[TY];
  float ar[TY], a0[TY], cn[TY];
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const bool real = c < W && r0 + li < H;
    const long i = (long)(r0 + li) * W + c;
    pk[li] = real ? __ldg(packed + i) : 0;
    ar[li] = real ? __ldg(area + i) : 0.0f;
    a0[li] = real ? __ldcg(A + i) : 0.0f;
  }
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const long i = (long)(r0 + li) * W + c;
    src[li] = (pk[li] & kSrcBit) ? __ldg(conn_src + i) : -1;
    dst[li] = (pk[li] & kDstBit) ? __ldg(conn_dst + i) : -1;
  }
  // a connection with both ends in the tile is read live from the tile;
  // one whose other end lies in another tile, at the visit's start
  uint32_t remote_dst = 0;  // the rows whose sink's attach pixel is away
  uint32_t remote_src = 0;  // the rows whose attach pixel's sink is away
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const bool src_here =
        src[li] >= 0 && tile_of<TY, TX>(src[li], W, nbx) == blockIdx.x;
    if (src[li] >= 0 && !src_here) remote_src |= 1u << li;
    cn[li] = src[li] >= 0 && !src_here ? __ldcg(A + src[li]) : 0.0f;
    if (src_here) {
      const int q = tile_cell<TX>(src[li], r0, c0, W);
      src[li] = (q / TX + 1) * SW + q % TX + 1;
    } else {
      src[li] = -1;
    }
    if (dst[li] >= 0 && tile_of<TY, TX>(dst[li], W, nbx) == blockIdx.x) {
      dst[li] = tile_cell<TX>(dst[li], r0, c0, W);
    } else {
      if (dst[li] >= 0) remote_dst |= 1u << li;
      dst[li] = -1;
    }
  }
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const int p = pk[li];
    const bool real = c < W && r0 + li < H;
    sMeta[li * TX + t] = (uint16_t)(
        !real ? 0
              : kReal | (p & 0xff) |
                    (feeds_row((p >> 8) & 0xff, r0 + li, H) ? kFeed : 0) |
                    (p & kSrcBit ? kAttach : 0));
    sArea[li * TX + t] = ar[li];
    sConn[li * TX + t] = cn[li];
    sSrc[li * TX + t] = (int16_t)src[li];
    sDst[li * TX + t] = (int16_t)dst[li];
  }
  // (relax's barrier orders these stores before the first pass)

  // The rows whose inputs may have changed since the tile last left its
  // cells at its local fixpoint (every row in round 0): the rows next to
  // the halo cells that the neighbours' edge bits say were written, in
  // the strips that read them, and the rows of the attach pixels whose
  // sinks lie in other tiles.  Every other row still satisfies its
  // equations (its cells and the cells it reads are as they were).
  constexpr uint64_t kAll = TY == 64 ? ~0ull : (1ull << TY) - 1;
  constexpr uint64_t kFirst = 1, kLast = 1ull << (TY - 1);
  const int w = t / 32, w_last = (min(TX, W - c0) - 1) / 32;
  const uint32_t far_rows = __reduce_or_sync(~0u, remote_src);
  uint64_t dirty = kAll;
  if (!cold) {
    dirty = (woke & kBottom ? kFirst : 0) | (woke & kTop ? kLast : 0) |
            (woke & kRemote ? far_rows : 0);
    if (w == 0)
      dirty |= (woke & kRight ? kAll : 0) |
               (woke & kBottomRight ? kFirst : 0) |
               (woke & kTopRight ? kLast : 0);
    if (w == w_last)
      dirty |= (woke & kLeft ? kAll : 0) |
               (woke & kBottomLeft ? kFirst : 0) |
               (woke & kTopLeft ? kLast : 0);
  }

  int passes;
  const uint64_t touched = relax<TY, TX>(
      [&](int li) {
        const int m = sMeta[li * TX + t];
        if (!(m & kReal)) return 0;
        const int ctr = (li + 1) * SW + t + 1;
        float acc = sArea[li * TX + t];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if ((m >> k) & 1)
            acc = __fadd_rn(
                acc, sA[nbr_slot<TY, TX>(li, t, k, r0, c0, H, W, wrap)]);
        if (m & kAttach) {
          const int q = sSrc[li * TX + t];
          acc = __fadd_rn(acc, q >= 0 ? sA[q] : sConn[li * TX + t]);
        }
        if (__float_as_int(acc) == __float_as_int(sA[ctr])) return 0;
        sA[ctr] = acc;
        const int d = sDst[li * TX + t];
        if (d >= 0)  // the attach pixel's row, in its strip, next pass
          atomicOr(&links[(d % TX) / 32], 1ull << (d / TX));
        return m & kFeed ? 3 : 1;
      },
      &passes, links, dirty);

  uint64_t wrote = 0;
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    if (!((touched >> li) & 1)) continue;
    const long i = (long)(r0 + li) * W + c;
    const float v = sA[(li + 1) * SW + t + 1];
    if (__float_as_int(v) != __float_as_int(a0[li])) {
      __stcg(A + i, v);
      wrote |= 1ull << li;
      if ((remote_dst >> li) & 1)
        atomicOr(cur + 2 * nt + tile_of<TY, TX>(__ldg(conn_dst + i), W, nbx),
                 kRemote);
    }
  }
  finish<TY, TX>(wrote, c, r0, c0, H, W, &out, cur, stats, slot, passes);
}

// K8's visit with the clamped targets and the lake sinks' connections: a
// sink whose attach pixel lies in the tile points at it, one whose attach
// pixel lies in another tile is an end holding its value as read at the
// visit's start.  The pointers are set here, as point_down sets them,
// from the words read at the start.
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    lake_vis_tile_kernel(const int* __restrict__ packed,
                         const int* __restrict__ conn_src,
                         const int* __restrict__ conn_dst, uint8_t* vis,
                         int wrap_x, int* prev, int* cur, int* stats,
                         int slot, int H, int W, int nby, int nbx) {
  constexpr int SW = TX + 2, SN = (TY + 2) * SW;
  static_assert(TY <= 64, "a thread's rows are one 64-bit mask");
  static_assert(SN <= 32767, "a halo'd tile's cells are int16 indices");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  volatile uint8_t* sV = smem;
  volatile int16_t* sNext =
      reinterpret_cast<int16_t*>(smem + (SN + 15) / 16 * 16);
  const int nt = nby * nbx;
  if (!tile_awake(prev, cur, nby, nbx, &out, prev + 2 * nt)) return;

  const int t = threadIdx.x;
  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX, c = c0 + t;
  const bool wrap = wrap_x != 0;
  load_halo<TY, TX>(sV, vis, r0, c0, H, W);
  int pk[TY], dst[TY];
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const bool real = c < W && r0 + li < H;
    pk[li] = real ? __ldg(packed + (long)(r0 + li) * W + c) : 0;
  }
#pragma unroll
  for (int li = 0; li < TY; ++li)
    dst[li] = (pk[li] & kDstBit)
                  ? __ldg(conn_dst + (long)(r0 + li) * W + c) : -1;
  uint64_t far = 0;  // the rows whose other tile's attach pixel holds 1
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    if (dst[li] < 0) continue;
    if (tile_of<TY, TX>(dst[li], W, nbx) == blockIdx.x) {
      const int q = tile_cell<TX>(dst[li], r0, c0, W);
      dst[li] = (q / TX + 1) * SW + q % TX + 1;
    } else {
      if (__ldcg(vis + dst[li])) far |= 1ull << li;
      dst[li] = -1;
    }
  }
  for (int k = t; k < SN; k += TX) sNext[k] = (int16_t)k;
  __syncthreads();  // the halo and every pointer at itself

  uint64_t touched = 0;
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const int q = (li + 1) * SW + t + 1, o = (pk[li] >> 8) & 0xff;
    if (o)
      sNext[q] = (int16_t)nbr_slot<TY, TX>(li, t, __ffs(o) - 1, r0, c0, H,
                                           W, wrap);
    else if (dst[li] >= 0)
      sNext[q] = (int16_t)dst[li];
    if (((far >> li) & 1) && !sV[q]) {
      sV[q] = 1;
      touched |= 1ull << li;
    }
  }
  __syncthreads();

  int passes = 0;
  for (bool changed = true; changed && passes <= SN; ++passes) {
    changed = false;
    for (int li = 0; li < TY; ++li) {
      const int q = (li + 1) * SW + t + 1;
      const int n = sNext[q];
      if (n == q || sV[q]) continue;
      if (sV[n]) {
        sV[q] = 1;
        touched |= 1ull << li;
        changed = true;
      } else if (sNext[n] != n) {
        sNext[q] = sNext[n];
        changed = true;
      }
    }
    changed = __syncthreads_or(changed);
  }

  // a touched cell went from 0 to 1, and only this block writes it; an
  // attach pixel wakes its sink's tile where that is another tile
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    if (!((touched >> li) & 1)) continue;
    const long i = (long)(r0 + li) * W + c;
    vis[i] = 1;
    if (pk[li] & kSrcBit) {
      const int g = tile_of<TY, TX>(__ldg(conn_src + i), W, nbx);
      if (g != blockIdx.x) atomicOr(cur + 2 * nt + g, kRemote);
    }
  }
  finish<TY, TX>(touched, c, r0, c0, H, W, &out, cur, stats, slot, passes);
}

// The basin root by pointer jumping along the code's out bits (no remote
// reads, no wake words): ends pinned at a sink (its own flat index), a
// cell without an out bit (-1), a halo cell and a cell whose clamped
// target is itself (root as loaded).
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    lake_root_tile_kernel(const int* __restrict__ packed, int* root,
                          int wrap_x, int* prev, int* cur, int* stats,
                          int slot, int H, int W, int nby, int nbx) {
  constexpr int SW = TX + 2, SN = (TY + 2) * SW;
  static_assert(TY <= 64, "a thread's rows are one 64-bit mask");
  static_assert(SN <= 32767, "a halo'd tile's cells are int16 indices");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  volatile int* sE = reinterpret_cast<int*>(smem);
  volatile int16_t* sNext =
      reinterpret_cast<int16_t*>(smem + sizeof(int) * SN);
  if (!tile_awake(prev, cur, nby, nbx, &out)) return;

  const int t = threadIdx.x;
  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX, c = c0 + t;
  const bool wrap = wrap_x != 0;
  load_halo<TY, TX>(sE, root, r0, c0, H, W);
  int pk[TY], e0[TY];
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    const bool real = c < W && r0 + li < H;
    const long i = (long)(r0 + li) * W + c;
    pk[li] = real ? __ldg(packed + i) : 0;
    e0[li] = real ? __ldcg(root + i) : 0;
  }
  for (int k = t; k < SN; k += TX) sNext[k] = (int16_t)k;
  __syncthreads();  // the halo and every pointer at itself
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    if (c >= W || r0 + li >= H) continue;
    const int q = (li + 1) * SW + t + 1, o = (pk[li] >> 8) & 0xff;
    if (o)
      sNext[q] = (int16_t)nbr_slot<TY, TX>(li, t, __ffs(o) - 1, r0, c0, H,
                                           W, wrap);
    else
      sE[q] = (pk[li] & kSinkBit) ? (r0 + li) * W + c : -1;
  }
  __syncthreads();

  int passes = 0;
  for (bool changed = true; changed && passes <= SN; ++passes) {
    changed = false;
    for (int li = 0; li < TY; ++li) {
      const int q = (li + 1) * SW + t + 1;
      const int n = sNext[q], m = sNext[n];
      if (m != n) {
        sNext[q] = (int16_t)m;
        changed = true;
      }
    }
    changed = __syncthreads_or(changed);
  }

  // every pointer is at an end, and no end is written here
  uint64_t wrote = 0;
#pragma unroll
  for (int li = 0; li < TY; ++li) {
    if (c >= W || r0 + li >= H) continue;
    const int e = sE[sNext[(li + 1) * SW + t + 1]];
    if (e != e0[li]) {
      __stcg(root + (long)(r0 + li) * W + c, e);
      wrote |= 1ull << li;
    }
  }
  finish<TY, TX>(wrote, c, r0, c0, H, W, &out, cur, stats, slot, passes);
}

// ---------------------------------------------------------------------------
// The one-sweep kernel (the yardstick).
// ---------------------------------------------------------------------------

// NEIGHBORS_FLOW_ORDER (core/topology.py): (dx, dy), row y + dy
__constant__ int kDx[8] = {1, 0, -1, 1, -1, 1, 0, -1};
__constant__ int kDy[8] = {1, 1, 1, 0, 0, -1, -1, -1};

__device__ __forceinline__ int neighbour(int y, int x, int k, int H, int W,
                                         bool wrap_x) {
  const int ny = min(max(y + kDy[k], 0), H - 1);
  int nx = x + kDx[k];
  if (wrap_x)
    nx = nx < 0 ? nx + W : (nx >= W ? nx - W : nx);
  else
    nx = min(max(nx, 0), W - 1);
  return ny * W + nx;
}

__global__ void __launch_bounds__(kThreads)
lake_relax_sweep(const int* __restrict__ packed,
                 const float* __restrict__ area,
                 const int* __restrict__ conn_src,
                 const int* __restrict__ conn_dst,
                 const float* __restrict__ A_in,
                 const uint8_t* __restrict__ vis_in,
                 const int* __restrict__ root_in,
                 float* __restrict__ A_out,
                 uint8_t* __restrict__ vis_out,
                 int* __restrict__ root_out, int H, int W,
                 bool wrap_x) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const int p = y * W + x;
  const int bits = packed[p];

  float a = area[p];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (bits & (1 << k))
      a = __fadd_rn(a, A_in[neighbour(y, x, k, H, W, wrap_x)]);
  }
  if (bits & kSrcBit) a = __fadd_rn(a, A_in[conn_src[p]]);
  A_out[p] = a;

  uint8_t v = (bits >> 16) & 1;
  int r = (bits & kSinkBit) ? p : -1;
  const int out = (bits >> 8) & 0xff;
  if (out) {
    const int n = neighbour(y, x, __ffs(out) - 1, H, W, wrap_x);
    v |= vis_in[n];
    if (root_in) r = root_in[n];
  }
  if (bits & kDstBit) v |= vis_in[conn_dst[p]];
  vis_out[p] = v;
  if (root_out) root_out[p] = r;
}

}  // namespace

extern "C" {

// The tiled solve's three kernels: n rounds each, the first being the
// solve's round `first`.  flags: 4 x nt words (the 2 x nt edge bits all
// set before round 0, then the 2 x nt wake words all 0; the root solve
// reads only the edge bits); stats as K7's (stats[2..2+n) zeroed here).
// wrap_x: 1 on an x-periodic grid (columns wrap), 0 elsewhere (clamp).
// (ty, tx) must be the built tile, else cudaErrorInvalidValue.
int demiurge_lake_area_tiles(const int* packed, const float* area,
                             const int* conn_src, const int* conn_dst,
                             float* A, int wrap_x, int* flags, int* stats,
                             int H, int W, int ty, int tx, int first, int n,
                             void* stream) {
  if (ty != kTileRows || tx != kTileCols) return (int)cudaErrorInvalidValue;
  return tile_rounds(lake_area_tile_kernel<kTileRows, kTileCols>,
                     lake_area_smem<kTileRows, kTileCols>(), ty, tx, flags,
                     stats, H, W, first, n, (cudaStream_t)stream, packed,
                     area, conn_src, conn_dst, A, wrap_x);
}

// vis: one byte a cell, starting at the mouths
int demiurge_lake_vis_tiles(const int* packed, const int* conn_src,
                            const int* conn_dst, uint8_t* vis, int wrap_x,
                            int* flags, int* stats, int H, int W, int ty,
                            int tx, int first, int n, void* stream) {
  if (ty != kTileRows || tx != kTileCols) return (int)cudaErrorInvalidValue;
  return tile_rounds(lake_vis_tile_kernel<kTileRows, kTileCols>,
                     lake_vis_smem<kTileRows, kTileCols>(), ty, tx, flags,
                     stats, H, W, first, n, (cudaStream_t)stream, packed,
                     conn_src, conn_dst, vis, wrap_x);
}

// root: int32, any start in which a cell that points at itself holds -1
// (kernels/lakeflow.py root_start)
int demiurge_lake_root_tiles(const int* packed, int* root, int wrap_x,
                             int* flags, int* stats, int H, int W, int ty,
                             int tx, int first, int n, void* stream) {
  if (ty != kTileRows || tx != kTileCols) return (int)cudaErrorInvalidValue;
  return tile_rounds(lake_root_tile_kernel<kTileRows, kTileCols>,
                     lake_root_smem<kTileRows, kTileCols>(), ty, tx, flags,
                     stats, H, W, first, n, (cudaStream_t)stream, packed,
                     root, wrap_x);
}

// The one-sweep kernel: n sweeps, one launch each: sweep 0 reads set 0
// (A0 vis0 root0) and writes set 1, then sets 1 and 2 alternate, so the
// last sweep writes set 1 for odd n and set 2 for even n.  Set 0 is not
// written.  root pointers null: root is not carried.  vis is one byte a
// cell (torch.bool).  wrap_x as above.
int demiurge_lake_relax(const int* packed, const float* area,
                        const int* conn_src, const int* conn_dst,
                        const float* A0, const uint8_t* vis0,
                        const int* root0, float* A1, uint8_t* vis1,
                        int* root1, float* A2, uint8_t* vis2, int* root2,
                        int H, int W, int wrap_x, int n, void* stream) {
  if (H <= 0 || W <= 0 || n < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < n; ++i) {
    const bool odd = (i & 1) != 0;
    const float* Ai = i == 0 ? A0 : (odd ? A1 : A2);
    const uint8_t* vi = i == 0 ? vis0 : (odd ? vis1 : vis2);
    const int* ri = i == 0 ? root0 : (odd ? root1 : root2);
    lake_relax_sweep<<<grid, kThreads, 0, s>>>(
        packed, area, conn_src, conn_dst, Ai, vi, ri, odd ? A2 : A1,
        odd ? vis2 : vis1, odd ? root2 : root1, H, W, wrap_x != 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"

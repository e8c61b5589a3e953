// The flow fixpoint — upstream area accumulation (K7) and mouth
// reachability (K8) — and the band-local fixpoints of the two-level solve
// (K10a, K10b), for Hopper (sm_90a), on one design: shared-memory tiles
// solved to a local fixpoint, in rounds that skip quiet tiles.
//
// K7 and K8 replace:
//   - demiurge_tpu/pallas_kernels/flow.py flow_solve_pallas (:294, _kernel
//     :83, _sweep_body :165) in mode "A" (the area half) and in modes
//     "vis"/"both" (its f32 reachability, the H % 32 != 0 fallback);
//   - demiurge_tpu/pallas_kernels/visbits.py vis_solve_bits (:102,
//     _kernel :58), the reachability bit-packed 32 rows to a word.  The
//     packing is a layout for the TPU's vector unit; here reachability is
//     one byte a pixel, the same kernel at every H.
//
// Over the packed masks (kernels/flow.py pack_masks: bits 0..7 incoming,
// 8..15 outgoing, 16 mouth; neighbour i at NEIGHBORS_FLOW_ORDER[i], x
// periodic, out-of-range rows already masked off) each kernel relaxes to
// the fixpoint of
//     A[p]   = area[p] + sum_{i in scan order, inc_i} A[neighbour_i]
//     vis[p] = vis[p] | OR_i (out_i & vis[neighbour_i])   (vis starts at
//                                                          the mouths)
// with the f32 sum taken by __fadd_rn in scan order.  D8 flow is acyclic,
// so each fixpoint is unique: A equals the plain twin's Jacobi result bit
// for bit from any start, and vis exactly.
//
// Design.  The TPU kernel keeps a row band resident in VMEM, runs up to k
// sweeps on it per visit and skips bands whose flags were quiet.  Here the
// unit is a 2-D tile of TY x TX cells (kTileRows x kTileCols, 16 x 128),
// one block of TX threads, thread t owning column t of the tile:
//   1. Wake.  Each tile leaves, for the next round, 8 edge bits: which of
//      its top and bottom rows, left and right columns and 4 corners it
//      wrote (the last real row and column on a ragged edge tile).  Thread
//      0 reads the bits of the 8 neighbour tiles that face this tile's
//      halo (x wraps, y clips); if none is set the block writes its own
//      bits 0 and returns: one load a block, not one a thread (a
//      per-thread early return on a flag stalled every block, PERF.md).
//      Round 0 runs every tile.
//   2. Load.  The tile and a one-cell halo of A (f32; vis: one byte) go to
//      shared memory; x wraps over the dateline inside the halo; rows
//      beyond the grid load as 0 (no mask bit reads them).  Beside them
//      sit, for K7, each cell's 8 incoming bits, a "real" bit (edge tiles
//      are ragged where TX does not divide W or TY H), a "feeds its row"
//      bit (an edge of dy = 0 leaves it) and the area; for K8, each cell's
//      pointer down its path.  The halo stays as loaded for the whole
//      visit.
//   3. Solve the tile's local fixpoint in shared memory.  K8 (one out
//      edge a cell) jumps pointers along the paths (vis_tile_kernel).  K7
//      sums in scan order, so it relaxes (relax): each warp walks its own
//      32-column strip in passes over the strip's dirty rows, down on even
//      passes and up on odd ones.  A row is one step of the warp, repeated
//      while a cell that feeds its own row changed, which leaves the row
//      satisfied; a change makes the rows above and below dirty, so the
//      next row of a down pass sees it at once, and marks the rows of the
//      neighbour strip when it is in an edge column.  So a pass carries a
//      change along any stretch of a path that runs with it or sideways,
//      and a path needs about one pass per reversal of its direction in y.
//      Every row starts dirty; a row that is not dirty satisfies its
//      equations (neither it nor a cell it reads changed since it last
//      did), so when no row is dirty every cell of the tile is satisfied
//      against the halo as loaded.  The warps run free of each other; the
//      block meets once a pass.  (The row repeats and the passes are
//      capped at the longest path a row or a tile can hold, so a launch
//      ends even on masks with a cycle; the host then finds no certifying
//      round.)
//   4. Write back the cells whose bits changed (__stcg), leave the edge
//      bits, and count the visit (atomicAdd), its passes (atomicMax) and
//      whether it wrote (the round's flag).
// One launch is one round over every tile; the edge bits ping-pong between
// two arrays.  The host launches rounds in batches and reads the batch's
// round flags once (kernels/flow.py _solve_tiles_cuda); the rounds after
// the certifying one launch blocks that return after step 1.
//
// Why the stale halo is sound (K11a's argument, csrc/flow_deadends.cu,
// for whole tiles and halo cells).  A tile's cells are written by that
// tile's block only.  Claim: at the end of round t, every tile not woken
// for round t+1 (no cell of its halo was written in round t) satisfies its
// equations.  If it ran in round t, it solved against a halo that held to
// the end of the round, and its cells are its local fixpoint against it.
// If it did not run, it was not woken for round t, so it satisfied its
// equations at the end of round t-1 (induction; round 0 runs every tile),
// and neither its cells nor its halo changed since.  So a round in which no
// tile wrote leaves every cell satisfied: the global fixpoint.  A tile
// whose halo was written is woken by that write and solves again against
// the new halo.  Reads of other tiles' cells go through L2 (__ldcg), and
// 4-byte stores do not tear.  The argument asks nothing of the field but
// that a visit leave the tile's cells a function of its halo that
// satisfies the equations, so it holds for K10a's exit ids too, which are
// not monotone as vis is: a visit recomputes every cell of the tile from
// the halo as loaded and writes back the cells that differ.
//
// Bound on this card: device-memory bytes: read the masks, the area and
// the start and write A once (16 bytes a pixel, 0.0100 ms at 2048x1024),
// and the masks and vis (5 bytes a pixel, 0.0031 ms), at 3.35 TB/s; one
// add per flow edge is far below the f32 rate.  One-sweep-a-launch kernels
// touched every pixel in L2 on every sweep (~20 us each, 504 a solve); the
// tiles keep the sweeps in shared memory, skip clean rows and quiet tiles,
// and need about as many rounds as the longest path crosses tile edges.
//
// K10a and K10b, the band-local fixpoints of the two-level solve, replace
// demiurge_tpu/pallas_kernels/flow2.py flow_local_solve (:150,
// _local_kernel :78) and flow_local_vis (:331, _local_vis_kernel :291).
// Rows come in bands of `band`; kernels/flow2.py mask_local has already
// cleared the incoming bits that reach across a band edge.  A cell of a
// band's first row whose out bit points to the row before (dy = -1), or of
// its last row pointing to the row after (dy = +1), is a crossing cell:
//     A[p]   = area[p] + sum_{i in scan order, inc_i} A[neighbour_i]
//     E[p]   = own id (col on the band's first row, W + col on its last)
//              on a crossing cell; -1 where p has no out bit; else
//              E[target]
//     vis[p] = seed[p] on a crossing cell or without an out bit, else
//              seed[p] | vis[target]  (seed: max(mouth, seed), where vis
//              starts)
// The TPU kernel runs one band per grid step, rolling whole (band, W) slabs
// in VMEM.  Here bands need no block structure: a non-crossing cell's
// target lies in its own band, and the masked masks read nothing across a
// band edge, so a tile may hold several bands or parts of them.  A on the
// masked masks is K7's equation as it stands (K7 reads the incoming bits,
// and the dy = 0 out bits only as a hint), so K10a's A is K7's kernel from
// the start a0.  K10a's exit ids are exit_tile_kernel, K8's pointer jumping
// over int32 with crossing cells and cells without an out bit as ends, and
// K10b is K8's kernel with crossing cells as ends (band > 0).  The host
// runs A's and E's rounds side by side, one read for both a batch.
// Bound: as K7 and K8, plus the exit ids written once (4 bytes a pixel).

#include "flow_tiles.cuh"

namespace {

template <int TY, int TX>
constexpr size_t exit_smem() {
  return (sizeof(int) + sizeof(int16_t)) * (TY + 2) * (TX + 2);
}

// K7: one round of the tiled A relaxation (area_visit)
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    area_tile_kernel(const int* __restrict__ packed,
                     const float* __restrict__ area, float* A,
                     const int* __restrict__ prev, int* cur, int* stats,
                     int slot, int H, int W, int nby, int nbx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  if (!tile_awake(prev, cur, nby, nbx, &out)) return;

  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX;
  int passes;
  const uint64_t wrote =
      area_visit<TY, TX>(smem, packed, area, A, r0, c0, H, W, &passes);
  finish<TY, TX>(wrote, c0 + threadIdx.x, r0, c0, H, W, &out, cur, stats,
                 slot, passes);
}

// K8 (band 0) and K10b (band > 0): one round of the tiled vis solve
// (vis_visit: pointer jumping in the tile)
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    vis_tile_kernel(const int* __restrict__ packed, uint8_t* vis, int band,
                    const int* __restrict__ prev, int* cur, int* stats,
                    int slot, int H, int W, int nby, int nbx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  if (!tile_awake(prev, cur, nby, nbx, &out)) return;

  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX;
  int passes;
  const uint64_t touched =
      vis_visit<TY, TX>(smem, packed, vis, band, r0, c0, H, W, &passes);
  finish<TY, TX>(touched, c0 + threadIdx.x, r0, c0, H, W, &out, cur, stats,
                 slot, passes);
}

// K10a's exit ids: the ends are the crossing cells, pinned to their own
// id, the cells without an out bit, at -1, and the halo cells (and cells
// beyond the grid), at E as loaded.  The pointers jump until each points
// at an end (about log2 of the tile's longest path passes; in place, as
// K8's), then every cell of the grid takes its end's id.  E is not
// monotone, so the visit recomputes every cell against the halo it loaded
// and writes back the cells that differ from device memory.
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    exit_tile_kernel(const int* __restrict__ packed, int* E, int band,
                     const int* __restrict__ prev, int* cur, int* stats,
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
  load_halo<TY, TX>(sE, E, r0, c0, H, W);
  // (point_down's barriers order the ends' ids before the first pass)
  point_down<TY, TX>(sNext, packed, r0, c, H, W, [&](int o, int r, int li) {
    const int rl = r % band;
    const bool cross = crossing(o, rl, band);
    if (cross || !o)
      sE[(li + 1) * SW + t + 1] = !o ? -1 : (rl == 0 ? c : W + c);
    return cross;
  });

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
  for (int li = 0; li < TY; ++li) {
    if (c >= W || r0 + li >= H) continue;
    const long i = (long)(r0 + li) * W + c;
    const int e = sE[sNext[(li + 1) * SW + t + 1]];
    if (e != __ldcg(E + i)) {
      __stcg(E + i, e);
      wrote |= 1ull << li;
    }
  }
  finish<TY, TX>(wrote, c, r0, c0, H, W, &out, cur, stats, slot, passes);
}


}  // namespace

extern "C" {

// K7: n rounds of the tiled A relaxation, the first being the solve's
// round `first`.  flags: 2 x nt tiles' edge bits (all set before round 0);
// stats as above (stats[2..2+n) zeroed here).  (ty, tx) must be the built
// tile, else cudaErrorInvalidValue.
int demiurge_flow_area_tiles(const int* packed, const float* area, float* A,
                             int* flags, int* stats, int H, int W, int ty,
                             int tx, int first, int n, void* stream) {
  if (ty != kTileRows || tx != kTileCols) return (int)cudaErrorInvalidValue;
  return tile_rounds(area_tile_kernel<kTileRows, kTileCols>,
                     area_smem<kTileRows, kTileCols>(), ty, tx, flags, stats,
                     H, W, first, n, (cudaStream_t)stream, packed, area, A);
}

// K8 (band 0) and K10b (band > 0): n rounds of the tiled vis solve (vis:
// one byte a pixel, from the mouths, or from max(mouth, seed) for K10b);
// other arguments as K7's.
int demiurge_flow_vis_tiles(const int* packed, uint8_t* vis, int band,
                            int* flags, int* stats, int H, int W, int ty,
                            int tx, int first, int n, void* stream) {
  if (ty != kTileRows || tx != kTileCols || band < 0)
    return (int)cudaErrorInvalidValue;
  return tile_rounds(vis_tile_kernel<kTileRows, kTileCols>,
                     vis_smem<kTileRows, kTileCols>(), ty, tx, flags, stats,
                     H, W, first, n, (cudaStream_t)stream, packed, vis,
                     band);
}

// K10a's exit ids: n rounds of the tiled solve on bands of `band` rows (E
// int32, any start); other arguments as K7's.  K10a's A is K7's entry
// point on the masked masks.
int demiurge_flow_exit_tiles(const int* packed, int* E, int band, int* flags,
                             int* stats, int H, int W, int ty, int tx,
                             int first, int n, void* stream) {
  if (ty != kTileRows || tx != kTileCols || band < 1)
    return (int)cudaErrorInvalidValue;
  return tile_rounds(exit_tile_kernel<kTileRows, kTileCols>,
                     exit_smem<kTileRows, kTileCols>(), ty, tx, flags, stats,
                     H, W, first, n, (cudaStream_t)stream, packed, E, band);
}

}  // extern "C"

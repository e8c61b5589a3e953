// The reference's alternative flow solvers, for Hopper (sm_90a): the same
// (A, vis) fixpoint as csrc/flow.cu (K7/K8), reached four other ways.
//
// Replaces:
//   - K11d  tools/flow_rounds.py main (:24), whose kernel is
//           demiurge_tpu/pallas_kernels/flow.py _kernel (:83): banded rounds
//           of k sweeps with 3-bit band flags, read by the host every round.
//           Here one launch a round, each band's window held in a thread-
//           block cluster's distributed shared memory (below); the TPU
//           design's one launch a sweep stays as the yardstick;
//   - K11a  attic/flow_deadends.py flow_solve_pallas_2d (:115, _kernel2d
//           :34): 2-D tiles that skip when their 3x3 tile neighbourhood was
//           quiet last round.  Here in one persistent launch on TMA windows
//           (below); the TPU design's one launch a sweep stays as the
//           yardstick;
//   - K11b  attic/flow_deadends.py flow_solve_fused (:319, _kernel_fused
//           :182): the whole solve in one launch with the stop test on the
//           device.  Here on K7/K8's tiles (below); the TPU design's band
//           windows, k sweeps a round and narrow windows go;
//   - K11c  attic/flow_deadends.py flow_solve_wave (:804, _kernel_wave
//           :534): the delta wave.  Here blocked in time on tiles that skip
//           where the wave has died, in one persistent launch (below); one
//           launch a sweep of every pixel stays as the yardstick.
//
// Over the packed masks (kernels/flow.py pack_masks: bits 0..7 incoming,
// 8..15 outgoing, 16 mouth; neighbour i at NEIGHBORS_FLOW_ORDER[i], x
// periodic, out-of-range rows already masked off) a sweep of a cell is, in
// place, one thread per pixel, as in K7/K8:
//     A[p]   = area[p] + sum_{i in scan order, inc_i} A[neighbour_i]
//     vis[p] = vis[p] | OR_i (out_i & vis[neighbour_i])
// and writes only when its bits change.
//
// Why skipping is sound under in-place sweeps (K11d, both designs, and the
// earlier K11a and K11b, kept as the yardsticks).  Concurrent blocks see
// each other's writes within a sweep, so how far a change travels in one
// sweep is not bounded; the skip rules below do not rely on such a bound.
// Let D_t be the cells written in round t and S_{t+1} the cells that round
// t+1 sweeps.  Each rule puts every cell with a neighbour (or itself) in
// D_t into S_{t+1}:
//   - K11d: band b runs if it changed (bit 0), if band b-1 changed within
//     k >= 1 rows of its high edge (bit 2) or band b+1 within k rows of its
//     low edge (bit 1), and a cell's neighbours lie in its own row band or
//     in the facing edge row of the next one;
//   - K11a's earlier design: a tile runs if a tile of its 3x3 tile
//     neighbourhood (x wraps, y clips) changed; tiles are at least one
//     cell wide;
//   - K11b: band b sweeps the columns [lo - k, hi + k] (cyclic) of the
//     merged change range [lo, hi] of bands b-1, b, b+1, or the whole row.
// Claim: a cell x outside S_{t+1} satisfies its equation at the end of
// round t.  Its neighbours and x itself did not change in round t.  If x
// was swept in round t, that sweep computed x from inputs that stayed
// fixed to the end of the round, so x satisfies it; if not, x was outside
// S_t and satisfied it at the end of round t-1 (induction; the first round
// sweeps everything), and nothing it reads has changed since.  So a round
// that writes nothing leaves every cell satisfied: the fixpoint, which is
// unique (D8 flow is acyclic), so A equals K7's bit for bit and vis K8's.
// K11b also stops a round early after a sweep that wrote nothing: every
// swept cell then holds its value, and the rest of the round is a no-op.
//
// K11d on windows: one launch a round, one cluster of C blocks for each
// (woken band, column segment).  The window is the band's rows and k rows
// above and below, and the segment's columns and k columns each side
// (across the dateline where it lies there); where one segment spans the
// whole width the window is the whole row, and its ends meet inside the
// cluster.  Block `rank` holds a contiguous slice of the window's columns,
// and one margin column each side: copies of its neighbours' edge
// columns, which a write pushes into the neighbour's shared memory
// (distributed shared memory), so a sweep reads only its own block.  The
// window runs up to k in-place sweeps, one cluster barrier after each, and
// stops after a sweep that changed nothing in the window (each block's
// __syncthreads_or, ORed across the cluster).  The window's outermost row
// and column are read but never recomputed (rows beyond the grid are not
// computed either: no mask reads them).  Only the band's own cells that
// changed go back to device memory, and the flags come from them, as the
// TPU kernel's do.
// The skip argument above needs one more step here: a cell of the window
// is computed from window values that are not the device's (halo cells
// the window recomputed and never writes back, margins a push has not
// reached).  Every value the window holds is real: A starts at the area
// and each write is area + a float32 sum in scan order of other such
// values, and rounding is monotone, so every value lies between the start
// and the fixpoint and only grows; vis only turns on.  So a window value
// is at least what the device held when the round began.  Now take x in
// band b that the round swept and whose band did not change (bit 0 clear):
// x was computed at least once (its first sweep) and the result was its
// loaded value, which is its device value at the round's start, G(x).  By
// monotony G(x) = f(window values) >= f(G's neighbours) >= G(x), the last
// since every value is at most f of any later neighbours.  So x satisfies
// its equation at the round's start; if none of its neighbours changed in
// the round, which is what a quiet wake says, it satisfies it at the end.
// The rest of the claim is as above, with "band b changed" meaning a write
// back: a band whose only changes were halo cells of its window wakes
// nothing, and needs to, since the owner of those cells computes them
// itself.  A cell whose band changed runs again next round.  So the last
// round, which writes nothing, leaves every cell satisfied.
// tests/test_torch_flow_banded_cluster.py runs this schedule in numpy and
// shows three mutations stopping short: a window that does not wrap at the
// dateline, a band woken by its own bit 0 alone, and an outer ring
// recomputed with its absent neighbours read as 0.
//
// K11c is not in place for the wave: delta must be delivered exactly once,
// so delta lives in ping-pong buffers (Jacobi), A accumulates the new
// delta in place, and vis is K8's in-place OR sweep.  A sweep that leaves
// delta at exactly zero everywhere and vis unchanged certifies both
// fixpoints (the relaxation is nilpotent, so delta reaches exact zeros).
// Its A adds arrivals in hop order, another float32 sum than K7's: the
// twin's (kernels/flow_deadends.py flow_solve_wave_plain), d_s of sweep s
// the sum of d_{s-1} over a cell's incoming bits in bit order from 0.0f,
// A the area plus d_1, d_2, ... in sweep order.
//
// Bound on this card: device-memory bytes, as K7: read the masks, the area
// and write A and vis once (about 19 bytes a pixel); the sweeps stay in the
// 50 MB L2 at 2048x1024.  The designs test the reference's answers to the
// sweep count: tile and band skipping (K11a, K11d), one launch with the
// stop test on the device (K11b), and a wave that touches only what moved
// (K11c).
//
// K11a on TMA windows, one persistent cooperative launch a solve, K11b's
// shape: lists of (field, tile) entries in two parity slots, A's and
// vis's on different blocks, as many blocks as fit on the card, one
// grid.sync a round, the stop test on the device and one host read after
// it.  A tile is K7's 16 x 128.
//   - A visit's window comes by the Tensor Memory Accelerator: one thread
//     asks for 2-D boxes (`cp.async.bulk.tensor`) and an mbarrier reports
//     when their bytes have landed.  For the A field the box is the tile
//     plus one row above and below and 4 columns each side (136 x 4 bytes),
//     beside the tile's packed masks and area; for vis 16 columns each side
//     (160 bytes): a box's row and its first column must both lie on 16-
//     byte boundaries.  Rows beyond the grid come back 0, which the masks
//     never read.
//   - TMA does not wrap: a tile at the dateline also loads a side box of
//     the columns across it (the grid's last 4 or 16 columns, its first
//     4 or 16) and copies the one halo column it reads into its window.
//     tests/test_torch_flow_2d_tma.py shows that without it a river over
//     the dateline stops short.
//   - One window a block: thread 0 takes the next entry and issues its
//     boxes once the visit before has written back.  The mbarrier's phase
//     bit is kept across tiles and rounds.  (A ring of two windows, the
//     next entry's load in flight while the block sweeps, was slower at
//     every k: no visit waited on its load; PERF.md has the race.)
//   - A visit runs k in-place sweeps of its field against the halo as
//     loaded, down then up, and stops early after a sweep that wrote
//     nothing; it stores the cells that changed (A only grows and vis only
//     turns to 1, so a cell touched is a cell changed).  Each edge bit of
//     what it wrote wakes the same field's entry of the tile whose halo
//     it faces (K7's rule; x wraps, y clips), and a visit that did not end
//     on a quiet sweep wakes itself; a tile that is not woken then has its
//     cells satisfied against values no write has changed since.  (The
//     reference's rule, the 3x3 tile neighbourhood of a visit that wrote,
//     ran more visits and lost the race.)
//   - A neighbour's load may read a halo cell while this block writes it:
//     either value is sound, as in K7, since the write wakes that
//     neighbour for the next round.
//
// K11c, the delta wave blocked in time, one persistent cooperative launch
// a solve.  A wave tile is K8's 16 x 128 (32 x 128 lost the race in
// PERF.md), its window the tile plus a k-cell halo of delta (by cp.async,
// 16 bytes at a time, from L2)
// and of the incoming bits (a byte a cell).
//   - A visit runs k Jacobi sweeps of the wave on the shrinking trapezoid
//     of its window, ping-pong in shared memory: after sweep s every cell
//     s cells inside the window holds d_s, so the tile holds d_1 .. d_k
//     cell for cell as the twin's sweeps do.  Each thread adds its column's
//     d_s to A in registers in sweep order and writes A once a visit; the
//     tile's d_k goes to the other of two global delta buffers.
//   - Skipping: a wave tile runs in round t only if a tile of its 3x3
//     neighbourhood left a nonzero d_k in round t - 1 (it pushes them).
//     Its window lies in that neighbourhood (k <= the tile's sides, and
//     <= the ragged last column's width where there are more than three
//     tile columns), so a skipped tile's window holds no delta and every
//     d_s of its cells is 0: A stays exact.
//   - The stale half of the ping-pong: a tile that left no nonzero d_k
//     writes nothing, so the output buffer keeps its region's delta of
//     two rounds before.  Each tile records the round of its last nonzero
//     output (two parity slots), and a window reads a tile's region only
//     where that round is the one before; elsewhere it loads zeros.
//     tests/test_torch_flow_wave_tiles.py shows that reading the region
//     regardless puts old mass back into A.
//   - vis runs beside it as K11b's vis entries (K8's visit on 16 x 128
//     tiles, woken by pushed edge bits), in the same lists.  The solve
//     ends when both fields' lists are empty.
//
// K11b, the whole solve in one persistent cooperative launch on K7/K8's
// tiles (csrc/flow_tiles.cuh), as many blocks as the card holds at once,
// one thread a column of a 16 x 128 tile.  An entry is a (field, tile)
// pair: A's entries and, in mode "both", vis's.
//   - Round t walks a list of entries: every entry in round 0 (A's
//     first, the slower), after that the entries whose halo a visit of
//     the same field wrote in round t - 1.  A block takes the next entry
//     by an atomic counter, so a slow visit holds up only its own block,
//     and A's and vis's visits of a round run side by side on different
//     blocks: a round costs its slowest visit, not an A visit and a vis
//     visit one after the other.
//   - A visit solves one field of its tile to the local fixpoint against
//     its halo as loaded: A by K7's relaxation (area_visit), vis by K8's
//     pointer jumping (vis_visit); it writes back the cells that changed
//     and takes finish's edge bits.
//   - Waking is a push where K7 pulls (tile_awake): eight threads of the
//     visit each OR one set edge bit into the wake word of the same
//     field's entry of the tile it faces (the same 8 facing pairs, x
//     wraps, y clips), and the write that turns a word from 0 appends
//     that entry to the next round's list.  So a quiet round costs its
//     short list, not a test of every tile.
//   - One grid.sync ends a round.  Every block then reads the next list's
//     length: 0 ends the solve, since the last round's writes faced no
//     entry's halo, so by csrc/flow.cu's stale-halo argument every tile
//     satisfies both fields' equations; the round limit sets status 2
//     instead.  The host reads the status and the stats once, after the
//     launch.
// The argument is K7's for each field on its own: A's equations read only
// A and vis's only vis, a field's cells are written by its own entry's
// visit only, a visit solves against a halo that is stale only where a
// write of that field will wake it, and each fixpoint is unique, so A
// equals K7's bit for bit and vis K8's.  A write of one field must wake
// that field's entries: tests/test_torch_flow_fused_tiles.py runs this
// schedule in numpy and shows that dropping either field's writes from
// the wake stops that field short.
// Storage that a round reuses is laid out so no read races a clear: the
// lists and wake words in two slots by round parity, each wake word
// cleared by its entry's visit; the list lengths and walk counters in
// three, the lead thread clearing round t + 2's during round t, when the
// last reads of that slot (round t - 1's) have passed a grid.sync.

#include <climits>
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: the encoder
                   // is looked up at run time, tensor_map_encoder)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bands.cuh"
#include "flow_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockX = 128;
constexpr int kMaxBands = 1024;     // K11d's by-value band list
constexpr int kFusedThreads = 256;  // K11b's block

__constant__ int kDx[8] = {1, 0, -1, 1, -1, 1, 0, -1};
__constant__ int kDy[8] = {1, 1, 1, 0, 0, -1, -1, -1};

enum Mode { kBoth = 0, kOnlyA = 1, kOnlyVis = 2 };

__device__ __forceinline__ long neighbour(int r, int c, int k, int W) {
  int cc = c + kDx[k];
  cc = cc < 0 ? cc + W : (cc >= W ? cc - W : cc);
  return (long)(r + kDy[k]) * W + cc;
}

// One in-place sweep of cell (r, c) in the halves `mode` selects; true if
// it wrote.
__device__ __forceinline__ bool sweep_cell(const int* __restrict__ packed,
                                          const float* __restrict__ area,
                                          float* A, uint8_t* vis, int r,
                                          int c, int W, int mode) {
  const long i = (long)r * W + c;
  const int p = __ldg(packed + i);
  bool changed = false;
  if (mode != kOnlyVis) {
    float acc = __ldg(area + i);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if ((p >> k) & 1)
        acc = __fadd_rn(acc, __ldcg(A + neighbour(r, c, k, W)));
    if (__float_as_int(acc) != __float_as_int(__ldcg(A + i))) {
      __stcg(A + i, acc);
      changed = true;
    }
  }
  if (mode != kOnlyA) {
    const volatile uint8_t* v = vis;
    if (v[i] == 0 && (p >> 8) & 0xff) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (((p >> (8 + k)) & 1) && v[neighbour(r, c, k, W)]) {
          vis[i] = 1;
          changed = true;
        }
      }
    }
  }
  return changed;
}

__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }

// ---------------------------------------------------------------------------
// K11d's earlier design, the yardstick: one in-place sweep a launch over
// the rows of the bands the host listed, one thread a pixel.
// ---------------------------------------------------------------------------

struct BandList {
  unsigned short band[kMaxBands];
};

__global__ void banded_sweep_kernel(const int* __restrict__ packed,
                                    const float* __restrict__ area, float* A,
                                    uint8_t* vis, int* flags, int W, int band,
                                    int k, BandList list) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int rl = blockIdx.y % band;
  const int b = list.band[blockIdx.y / band];
  const bool changed =
      c < W && sweep_cell(packed, area, A, vis, b * band + rl, c, W, kBoth);
  if (__syncthreads_or(changed) && threadIdx.x == 0)
    atomicOr(flags + b, 1 | (rl < k ? 2 : 0) | (rl >= band - k ? 4 : 0));
}

// ---------------------------------------------------------------------------
// K11d: a round on windows held in thread-block clusters (the design is in
// the header).  Cluster y of the grid is segment y % nseg of listed band
// y / nseg.  A block's shared memory, `sw` window columns of `rows` window
// rows (sw + 2 with the margins):
//   tail [2][kMaxCluster] the sweeps' cluster-wide OR, by parity, and one
//        word of the block's flag bits
//   A    [rows][sw + 2]  float
//   area [rows][sw]      float
//   inc  [rows][sw]      the incoming bits (packed & 0xff)
//   out  [rows][sw]      the outgoing bits ((packed >> 8) & 0xff)
//   vis  [rows][sw + 2]  bit 0 vis; bit 1 A changed here, bit 2 vis did
// flags (zeroed) gets each band's 3 bits at [b], the clusters that ran at
// [nb], the most sweeps a window ran at [nb + 1] and the blocks' clock
// cycles / 1024, summed, at [nb + 2 .. nb + 5]: loading the window,
// sweeping, at the sweeps' cluster barriers, writing back; next_flags,
// the next round's (kFlagWords more than the bands), is zeroed here.
// ---------------------------------------------------------------------------

namespace banded {

constexpr int kThreads = 512;
constexpr int kTail = 4 * (2 * bands::kMaxCluster + 1);
constexpr int kFlagWords = 6;  // past the bands' flags: see the kernel

// a block's shared bytes: `sw` columns of `rows` window rows
constexpr size_t smem(int rows, int sw) {
  return kTail + (size_t)rows * (11 * sw + 10);
}

__host__ __device__ constexpr int slice(int ww, int c) {
  return (ww + c - 1) / c;
}

// a window of `ww` columns on `c` blocks: every block has a column, and
// a thread for each of its columns, and the slices fit shared memory
bool window_ok(int rows, int ww, int c) {
  const int sw = slice(ww, c);
  return ww - (c - 1) * sw >= 1 && sw <= kThreads &&
         smem(rows, sw) <= bands::kMaxSmem;
}

// The plan kernels/flow_deadends.py plan_banded makes, checked: a power-
// of-two cluster of at most 16 blocks; one segment the whole width, or
// several of `seg` columns (the last 1 to seg) whose windows do not wrap
// onto themselves.
bool accepted(int H, int W, int band, int k, int c, int nseg, int seg) {
  if (c < 1 || c > bands::kMaxCluster || (c & (c - 1))) return false;
  if (band < 1 || H < band || H % band || k < 1 || k > band || W < 1 ||
      nseg < 1)
    return false;
  const int rows = band + 2 * k;
  if (nseg == 1) return seg == W && window_ok(rows, W, c);
  const int last = W - (nseg - 1) * seg;
  return last >= 1 && last <= seg && seg + 2 * k <= W &&
         window_ok(rows, seg + 2 * k, c) && window_ok(rows, last + 2 * k, c);
}

}  // namespace banded

__global__ void __launch_bounds__(banded::kThreads)
    banded_cluster_kernel(const int* __restrict__ packed,
                          const float* __restrict__ area, float* A,
                          uint8_t* vis, int* flags, int* next_flags, int H,
                          int W, int band, int k, int nseg, int seg,
                          BandList list) {
  extern __shared__ __align__(16) unsigned char win[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int th = threadIdx.x, nb = H / band;
  const int a = blockIdx.y / nseg, s = blockIdx.y - a * nseg;
  const int b = list.band[a], r0 = b * band;
  // one segment is the whole row: the window's ends meet at the dateline
  const bool wrap = nseg == 1;
  const int c0 = s * seg, segw = wrap ? W : min(seg, W - c0);
  const int WH = band + 2 * k, WW = wrap ? W : segw + 2 * k;
  const int sw = banded::slice(WW, C), stride = sw + 2;
  const int wx0 = rank * sw, ncols = rank == C - 1 ? WW - wx0 : sw;
  const int last_cols = WW - (C - 1) * sw;
  int* const sweep_any = reinterpret_cast<int*>(win);
  int* const block_bits = sweep_any + 2 * bands::kMaxCluster;
  float* const sAb = reinterpret_cast<float*>(win + banded::kTail);
  float* const sArea = sAb + WH * stride;
  uint8_t* const sInc = reinterpret_cast<uint8_t*>(sArea + WH * sw);
  uint8_t* const sOut = sInc + WH * sw;
  uint8_t* const sVb = sOut + WH * sw;
  volatile float* const sA = sAb;
  volatile uint8_t* const sV = sVb;

  if (blockIdx.y == 0 && rank == 0)
    for (int i = th; i < nb + banded::kFlagWords; i += blockDim.x)
      next_flags[i] = 0;
  if (th == 0) *block_bits = 0;
  // where this block's time goes (thread 0's clock): see flags nb + 2 ..
  long long spent[4] = {0, 0, 0, 0};
  long long clk = clock64();
  // the slice and its margins: window column wx0 + j - 1 at local column j
  const int cols2 = ncols + 2;
  for (int idx = th; idx < WH * cols2; idx += blockDim.x) {
    const int wr = idx / cols2, j = idx - wr * cols2;
    const int gr = r0 - k + wr, wx = wx0 + j - 1;
    bool in = gr >= 0 && gr < H;
    int gx;
    if (wrap) {
      gx = wx < 0 ? wx + W : (wx >= W ? wx - W : wx);
    } else {
      in = in && wx >= 0 && wx < WW;
      gx = (c0 - k + wx) % W;
      if (gx < 0) gx += W;
    }
    const long g = (long)(in ? gr : 0) * W + gx;
    sAb[wr * stride + j] = in ? __ldcg(A + g) : 0.0f;
    sVb[wr * stride + j] = in ? ld_cg(vis + g) : (uint8_t)0;
    if (j >= 1 && j <= ncols) {
      const int o = wr * sw + j - 1;
      const int p = in ? __ldg(packed + g) : 0;
      sArea[o] = in ? __ldg(area + g) : 0.0f;
      sInc[o] = (uint8_t)(p & 0xff);
      sOut[o] = (uint8_t)((p >> 8) & 0xff);
    }
  }
  // every block has loaded (and runs) before any push reaches it
  cluster.sync();
  spent[0] = clock64() - clk;

  // this thread's cells: column jcol of the slice, a group of its rows;
  // the window's outermost row and column, and rows beyond the grid, are
  // never computed
  const int G = blockDim.x / sw;
  const int jcol = th % sw + 1, grp = th / sw, wx = wx0 + jcol - 1;
  const int rlo = max(1, k - r0), rhi = min(WH - 1, H - r0 + k);
  const int per = (rhi - rlo + G - 1) / G;
  const int ra = rlo + grp * per, rb = min(rhi, ra + per);
  const bool mine = grp < G && jcol <= ncols && ra < rb &&
                    (wrap || (wx >= 1 && wx < WW - 1));
  const int west = rank > 0 ? rank - 1 : (wrap ? C - 1 : -1);
  const int east = rank < C - 1 ? rank + 1 : (wrap ? 0 : -1);
  const int west_cols = west == C - 1 ? last_cols : sw;
  const bool push_w = jcol == 1 && west >= 0;
  const bool push_e = jcol == ncols && east >= 0;

  int sweeps = 0;
  clk = clock64();
  for (int it = 0; it < k; ++it) {
    bool ch = false;
    if (mine) {
      for (int q = 0; q < rb - ra; ++q) {
        const int wr = (it & 1) ? rb - 1 - q : ra + q;  // down, then up
        const int o = wr * sw + jcol - 1, ctr = wr * stride + jcol;
        const int m = sInc[o];
        if (m) {
          // the eight reads in flight at once, then the sum in scan order
          float nbv[8];
#pragma unroll
          for (int d = 0; d < 8; ++d)
            nbv[d] = sA[ctr + dyk(d) * stride + dxk(d)];
          float acc = sArea[o];
#pragma unroll
          for (int d = 0; d < 8; ++d)
            if ((m >> d) & 1) acc = __fadd_rn(acc, nbv[d]);
          if (__float_as_int(acc) != __float_as_int(sA[ctr])) {
            sA[ctr] = acc;
            sV[ctr] = sV[ctr] | 2;
            ch = true;
            if (push_w)
              *cluster.map_shared_rank(sAb + wr * stride + west_cols + 1,
                                       (unsigned)west) = acc;
            if (push_e)
              *cluster.map_shared_rank(sAb + wr * stride, (unsigned)east) =
                  acc;
          }
        }
        const int ob = sOut[o];
        const int v = sV[ctr];
        if (ob && !(v & 1)) {
          int any = 0;
#pragma unroll
          for (int d = 0; d < 8; ++d)
            any |= ((ob >> d) & 1) & sV[ctr + dyk(d) * stride + dxk(d)];
          if (any) {
            sV[ctr] = (uint8_t)(v | 5);
            ch = true;
            if (push_w)
              *cluster.map_shared_rank(sVb + wr * stride + west_cols + 1,
                                       (unsigned)west) = 1;
            if (push_e)
              *cluster.map_shared_rank(sVb + wr * stride, (unsigned)east) =
                  1;
          }
        }
      }
    }
    sweeps = it + 1;
    {
      const long long now = clock64();
      spent[1] += now - clk;
      clk = now;
    }
    // the cluster's OR of its blocks' changes: each block's to every
    // block, in the slot of this sweep's parity
    const int any_here = __syncthreads_or(ch);
    if (th < C)
      *cluster.map_shared_rank(
          sweep_any + (it & 1) * bands::kMaxCluster + rank, (unsigned)th) =
          any_here;
    cluster.sync();
    int any = 0;
    for (int q = 0; q < C; ++q)
      any |= sweep_any[(it & 1) * bands::kMaxCluster + q];
    const long long now = clock64();
    spent[2] += now - clk;
    clk = now;
    if (!any) break;  // a quiet sweep: the rest would change nothing
  }
  // the band's own cells that changed go back, and their flag bits
  int bits = 0;
  if (mine && (wrap || (wx >= k && wx < k + segw))) {
    const int gx = wrap ? wx : c0 + wx - k;
    for (int wr = max(ra, k); wr < min(rb, k + band); ++wr) {
      const int ctr = wr * stride + jcol;
      const int v = sV[ctr];
      if (!(v & 6)) continue;
      const long g = (long)(r0 - k + wr) * W + gx;
      if (v & 2) __stcg(A + g, sA[ctr]);
      if (v & 4) vis[g] = 1;
      const int rl = wr - k;
      bits |= 1 | (rl < k ? 2 : 0) | (rl >= band - k ? 4 : 0);
    }
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((th & 31) == 0 && bits) atomicOr(block_bits, bits);
  __syncthreads();
  if (th == 0) {
    if (*block_bits) atomicOr(flags + b, *block_bits);
    if (rank == 0) {
      atomicAdd(flags + nb, 1);
      atomicMax(flags + nb + 1, sweeps);
    }
    spent[3] = clock64() - clk;
    for (int q = 0; q < 4; ++q)
      atomicAdd(flags + nb + 2 + q, (int)(spent[q] >> 10));
  }
}

// ---------------------------------------------------------------------------
// K11a: tiles of (ty, tx), tx a multiple of kBlockX, so a block's columns lie
// in one tile.  `act` is computed from the last round's flags before the
// round; a block of a quiet tile returns at once (one dependent load).
// ---------------------------------------------------------------------------

__global__ void tile_activity_kernel(const int* prev, int* act, int nby,
                                     int nbx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nby * nbx) return;
  const int i = t / nbx, j = t % nbx;
  int a = 0;
  for (int di = -1; di <= 1; ++di) {
    const int ii = i + di;
    if (ii < 0 || ii >= nby) continue;  // y clips
    for (int dj = -1; dj <= 1; ++dj) {
      const int jj = (j + dj + nbx) % nbx;  // x wraps over the dateline
      a |= prev[ii * nbx + jj];
    }
  }
  act[t] = a != 0;
}

__global__ void tile_sweep_kernel(const int* __restrict__ packed,
                                  const float* __restrict__ area, float* A,
                                  uint8_t* vis, const int* act, int* cur,
                                  int W, int ty, int tx, int nbx) {
  const int r = blockIdx.y;
  const int tile = (r / ty) * nbx + (blockIdx.x * kBlockX) / tx;
  if (ld(act + tile) == 0) return;  // uniform over the block
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const bool changed = c < W && sweep_cell(packed, area, A, vis, r, c, W,
                                           kBoth);
  if (__syncthreads_or(changed) && threadIdx.x == 0) cur[tile] = 1;
}

// ---------------------------------------------------------------------------
// K11c: one sweep of the delta wave.
// ---------------------------------------------------------------------------

__global__ void wave_sweep_kernel(const int* __restrict__ packed,
                                  const float* __restrict__ din, float* dout,
                                  float* A, uint8_t* vis, int* flag, int W) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  bool changed = false;
  if (c < W) {
    const long i = (long)r * W + c;
    const int p = __ldg(packed + i);
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if ((p >> k) & 1) d = __fadd_rn(d, __ldg(din + neighbour(r, c, k, W)));
    dout[i] = d;
    if (d != 0.0f) {
      A[i] = __fadd_rn(A[i], d);
      changed = true;
    }
    const volatile uint8_t* v = vis;
    if (v[i] == 0 && (p >> 8) & 0xff) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (((p >> (8 + k)) & 1) && v[neighbour(r, c, k, W)]) {
          vis[i] = 1;
          changed = true;
        }
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

// ---------------------------------------------------------------------------
// K11b: the whole solve in one persistent cooperative launch on K7/K8's
// tiles (the design is in the header).
//
// Workspace (int32), ne entries (nt tiles, times 2 in mode "both"; entry
// f * nt + tile is field f of the tile, f 0 for A):
//   edges  [ne]     finish's edge bits of each entry's last visit
//   wake   [2][ne]  round t + 1's wake words, in slot (t + 1) & 1
//   list   [2][ne]  round t's entries, in slot t & 1 (the caller fills
//                   slot 0 with every entry in order)
//   ctl: 0..2 list lengths of round t in slot t % 3 (the caller sets slot
//        0 to ne), 3..5 walk counters, 6..8 finish's stats (visits, most
//        passes a visit, some visit wrote), 9 status (1 converged, 2 out
//        of rounds), 10 rounds run
// Everything else zero.
// ---------------------------------------------------------------------------

constexpr int kFusedCtl = 5;  // ctl's offset, in ne

// A visit's shared memory: one field's solve
template <int MODE>
constexpr size_t fused_tile_smem() {
  constexpr size_t a = MODE == kOnlyVis ? 0 : area_smem<kTileRows, kTileCols>();
  constexpr size_t v = MODE == kOnlyA ? 0 : vis_smem<kTileRows, kTileCols>();
  return a > v ? a : v;
}

// The tile each edge bit faces (kBottom the tile below, kTopRight the one
// above and to the right, ...): tile rows down, tile columns right
__constant__ int kFaceBit[8] = {kBottom,      kTop,        kRight,
                                kLeft,        kBottomRight, kBottomLeft,
                                kTopRight,    kTopLeft};
__constant__ int kFaceDi[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__constant__ int kFaceDj[8] = {0, 0, 1, -1, 1, -1, 1, -1};

// Edge bit d of a visit's bits, pushed: it wakes the same field's entry
// (base + tile) of the tile whose halo it faces (x wraps, y clips), and
// the first bit to reach an entry appends it to the next round's list.
__device__ void wake_facing(int d, int base, int tile, int bits, int* wake,
                            int* list, int* count, int nby, int nbx) {
  const int bit = kFaceBit[d];
  const int ti = tile / nbx, tj = tile - ti * nbx;
  const int ii = ti + kFaceDi[d];
  if (!(bits & bit) || ii < 0 || ii >= nby) return;
  const int nb = base + ii * nbx + (tj + kFaceDj[d] + nbx) % nbx;
  if (atomicOr(wake + nb, bit) == 0) list[atomicAdd(count, 1)] = nb;
}

template <int MODE>
__global__ void __launch_bounds__(kTileCols)
    fused_tiles_kernel(const int* __restrict__ packed,
                       const float* __restrict__ area, float* A,
                       uint8_t* vis, int* ws, int H, int W, int max_rounds) {
  constexpr int TY = kTileRows, TX = kTileCols;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out, entry;
  const int nby = (H + TY - 1) / TY, nbx = (W + TX - 1) / TX;
  const int nt = nby * nbx, ne = (MODE == kBoth ? 2 : 1) * nt;
  int* const edges = ws;
  int* const wake = ws + ne;
  int* const list = ws + 3 * ne;
  int* const ctl = ws + kFusedCtl * ne;
  int* const stats = ctl + 6;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;

  for (int t = 0;; ++t) {
    const int n = ld_cg(ctl + t % 3);  // the same in every block
    if (n == 0 || t >= max_rounds) {
      if (lead) ctl[9] = n == 0 ? 1 : 2;
      return;
    }
    if (lead) {
      ctl[(t + 2) % 3] = 0;
      ctl[3 + (t + 2) % 3] = 0;
      ctl[10] = t + 1;
    }
    int* const now = list + (t & 1) * ne;
    int* const next_wake = wake + ((t + 1) & 1) * ne;
    int* const next_list = list + ((t + 1) & 1) * ne;
    int* const next_n = ctl + (t + 1) % 3;
    for (;;) {
      if (threadIdx.x == 0) {
        const int j = atomicAdd(ctl + 3 + t % 3, 1);
        entry = j < n ? ld_cg(now + j) : -1;
        if (entry >= 0) wake[(t & 1) * ne + entry] = 0;
        out = 0;
      }
      __syncthreads();
      const int e = entry;
      if (e < 0) break;
      const bool vis_field = MODE == kOnlyVis || (MODE == kBoth && e >= nt);
      const int base = MODE == kBoth && e >= nt ? nt : 0, tl = e - base;
      const int ti = tl / nbx, tj = tl - ti * nbx;
      const int r0 = ti * TY, c0 = tj * TX;
      int passes;
      const uint64_t wrote =
          vis_field
              ? vis_visit<TY, TX>(smem, packed, vis, 0, r0, c0, H, W, &passes)
              : area_visit<TY, TX>(smem, packed, area, A, r0, c0, H, W,
                                   &passes);
      finish<TY, TX>(wrote, c0 + threadIdx.x, r0, c0, H, W, &out, edges,
                     stats, 0, passes, e);
      // finish's barrier has made `out` whole: eight threads push its bits
      if (threadIdx.x < 8)
        wake_facing(threadIdx.x, base, tl, out & 0xff, next_wake, next_list,
                    next_n, nby, nbx);
      __syncthreads();  // before thread 0 takes the next entry
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The earlier K11b, kept callable as the yardstick: the TPU design, one
// pixel a thread, one grid.sync a sweep.
//
// Workspace (int32, zeroed but for prev_hi = W - 1 by the caller), nb bands:
//   cur_lo, cur_hi    [nb] this round's change range of each band
//   prev_lo, prev_hi  [nb] the last round's
//   act_band, act_start, act_n [nb] this round's swept windows
//   ctl: 0 nact, 1 done (1 converged, 2 out of rounds), 2..4 the sweep
//   changed-flag ring, 5 rounds, 6 sweeps, 7 band visits, 8 narrow visits
// The lead thread (block 0, thread 0) plans each round between grid syncs;
// every block strides over the (band, row) tasks of the round's windows.
// A sweep's changed flag is a ring of three slots: sweep g writes slot
// g % 3 and the lead clears slot (g + 1) % 3, which every block last read
// before the sync that ended sweep g - 1 (two slots would race with a
// block still reading after the last sync).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFusedThreads)
    fused_bands_kernel(const int* __restrict__ packed,
                 const float* __restrict__ area, float* A, uint8_t* vis,
                 int* ws, int H, int W, int band, int k, int narrow, int mode,
                 int max_rounds) {
  cg::grid_group grid = cg::this_grid();
  const int nb = H / band;
  int* cur_lo = ws;
  int* cur_hi = ws + nb;
  int* prev_lo = ws + 2 * nb;
  int* prev_hi = ws + 3 * nb;
  int* act_band = ws + 4 * nb;
  int* act_start = ws + 5 * nb;
  int* act_n = ws + 6 * nb;
  int* ctl = ws + 7 * nb;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  __shared__ int s_lo[kFusedThreads / 32], s_hi[kFusedThreads / 32];
  int g = 0;  // sweeps so far, the same in every block

  for (int round = 0;; ++round) {
    if (lead) {
      if (round > 0) {
        for (int b = 0; b < nb; ++b) {  // other blocks' atomics: via L2
          prev_lo[b] = ld(cur_lo + b);
          prev_hi[b] = ld(cur_hi + b);
        }
      }
      int nact = 0;
      for (int b = 0; b < nb; ++b) {
        cur_lo[b] = INT_MAX;
        cur_hi[b] = -1;
        int lo = INT_MAX, hi = -1;
        for (int bb = max(b - 1, 0); bb <= min(b + 1, nb - 1); ++bb) {
          if (prev_hi[bb] < 0) continue;
          lo = min(lo, prev_lo[bb]);
          hi = max(hi, prev_hi[bb]);
        }
        if (hi < 0) continue;
        int start = 0, n = W;
        const int width = hi - lo + 1 + 2 * k;
        if (width <= narrow && width < W) {
          start = lo - k < 0 ? lo - k + W : lo - k;
          n = width;
          ++ctl[8];
        }
        act_band[nact] = b;
        act_start[nact] = start;
        act_n[nact] = n;
        ++nact;
      }
      ctl[7] += nact;
      ctl[0] = nact;
      ctl[1] = nact == 0 ? 1 : (round >= max_rounds ? 2 : 0);
      if (ctl[1] == 0) ctl[5] = round + 1;
    }
    grid.sync();
    if (ld(ctl + 1) != 0) break;
    const int ntasks = ld(ctl) * band;

    for (int s = 0; s < k; ++s) {
      int* flag = ctl + 2 + g % 3;
      if (lead) ctl[2 + (g + 1) % 3] = 0;
      for (int t = blockIdx.x; t < ntasks; t += gridDim.x) {
        const int a = t / band;
        const int b = ld(act_band + a);
        const int r = b * band + t % band;
        const int start = ld(act_start + a), n = ld(act_n + a);
        int lo = INT_MAX, hi = -1;
        for (int j = threadIdx.x; j < n; j += kFusedThreads) {
          const int c = start + j < W ? start + j : start + j - W;
          if (sweep_cell(packed, area, A, vis, r, c, W, mode)) {
            lo = min(lo, c);
            hi = max(hi, c);
          }
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if ((threadIdx.x & 31) == 0) {
          s_lo[threadIdx.x / 32] = lo;
          s_hi[threadIdx.x / 32] = hi;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int w = 1; w < kFusedThreads / 32; ++w) {
            lo = min(lo, s_lo[w]);
            hi = max(hi, s_hi[w]);
          }
          if (hi >= 0) {
            atomicMin(cur_lo + b, lo);
            atomicMax(cur_hi + b, hi);
            atomicExch(flag, 1);
          }
        }
        __syncthreads();
      }
      grid.sync();
      ++g;
      if (lead) ++ctl[6];
      if (ld(flag) == 0) break;  // this sweep wrote nothing: round over
    }
  }
}


// ---------------------------------------------------------------------------
// K11a on TMA windows (the design is in the header).
//
// Workspace (int32), ne = 2 nt entries (entry f * nt + tile is field f of
// the tile, f 0 for A):
//   wake  [2][ne]  round t + 1's wake words, in slot (t + 1) & 1
//   list  [2][ne]  round t's entries, in slot t & 1 (the caller fills
//                  slot 0 with every entry in order)
//   ctl: 0..2 list lengths of round t in slot t % 3 (the caller sets slot
//        0 to ne), 3..5 walk counters, 6 visits, 7 most sweeps a visit,
//        8 unused, 9 status (1 converged, 2 out of rounds), 10 rounds run,
//        11..15 the blocks' clock cycles / 1024, summed: waiting for a
//        window, sweeping, writing back and waking, at the grid syncs,
//        and in all (the rest is taking entries and issuing loads)
// Everything else zero.
// ---------------------------------------------------------------------------

namespace tma {

constexpr int TY = kTileRows, TX = kTileCols;
constexpr int kRows = TY + 2;          // a box: the tile and a row each side
// columns each side: 16 bytes, since a box's first column must start on
// a 16-byte boundary (vis's box at 8 columns is an illegal instruction)
constexpr int kPadA = 4, kPadV = 16;
constexpr int kBoxA = TX + 2 * kPadA;  // 136 floats, 544 bytes
constexpr int kBoxV = TX + 2 * kPadV;  // 160 bytes
constexpr int kSideA = 4, kSideV = 16;  // the side boxes over the dateline
constexpr uint32_t kBoxABytes = kRows * kBoxA * 4;
constexpr uint32_t kBoxVBytes = kRows * kBoxV;
constexpr uint32_t kSideABytes = kRows * kSideA * 4;
constexpr uint32_t kSideVBytes = kRows * kSideV;
constexpr uint32_t kTileBytes = TY * TX * 4;  // the packed masks, the area

constexpr uint32_t align128(uint32_t n) { return (n + 127) / 128 * 128; }
// the window: the box, the two side boxes, the packed masks, the area
constexpr uint32_t kOffWL = align128(kBoxABytes);
constexpr uint32_t kOffWR = kOffWL + align128(kSideABytes);
constexpr uint32_t kOffPacked = kOffWR + align128(kSideABytes);
constexpr uint32_t kOffArea = kOffPacked + kTileBytes;
constexpr size_t kSmem = kOffArea + kTileBytes + 128;  // 128-byte aligned
static_assert(kBoxVBytes <= kOffWL && kSideVBytes <= kOffWR - kOffWL,
              "vis's boxes fit in A's places");

struct Maps {
  CUtensorMap A, A_side, vis, vis_side, packed, area;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(bar))
               : "memory");
}

// a load's one arrival, with the bytes its boxes will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// a 2-D box of `map` from column x, row y into shared memory, on `bar`;
// cells beyond the grid come back 0
__device__ __forceinline__ void box(void* dst, const CUtensorMap* map,
                                    uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(x), "r"(y)
      : "memory");
}

// thread 0: the boxes of entry e into the window, on its mbarrier
__device__ void issue(const Maps& maps, unsigned char* slot, uint64_t* bar,
                      int e, int nt, int nbx, int W) {
  const bool vf = e >= nt;
  const int tile = vf ? e - nt : e;
  const int ti = tile / nbx, tj = tile - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX;
  const bool left = tj == 0, right = tj == nbx - 1;
  // the block's last reads and writes of the window (generic proxy) come
  // before the boxes' writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (!vf) {
    mbar_expect(bar, kBoxABytes + 2 * kTileBytes +
                         (left ? kSideABytes : 0) +
                         (right ? kSideABytes : 0));
    box(slot, &maps.A, bar, c0 - kPadA, r0 - 1);
    if (left) box(slot + kOffWL, &maps.A_side, bar, W - kSideA, r0 - 1);
    if (right) box(slot + kOffWR, &maps.A_side, bar, 0, r0 - 1);
    box(slot + kOffArea, &maps.area, bar, c0, r0);
  } else {
    mbar_expect(bar, kBoxVBytes + kTileBytes + (left ? kSideVBytes : 0) +
                         (right ? kSideVBytes : 0));
    box(slot, &maps.vis, bar, c0 - kPadV, r0 - 1);
    if (left) box(slot + kOffWL, &maps.vis_side, bar, W - kSideV, r0 - 1);
    if (right) box(slot + kOffWR, &maps.vis_side, bar, 0, r0 - 1);
  }
  box(slot + kOffPacked, &maps.packed, bar, c0, r0);
}

// thread 0: the next entry of round t's list (-1: none left); it clears
// the entry's wake word for the round after next
__device__ __forceinline__ int take(int* ctl, const int* list, int* wake,
                                    int t, int n, int ne) {
  const int j = atomicAdd(ctl + 3 + t % 3, 1);
  const int e = j < n ? ld_cg(list + (t & 1) * ne + j) : -1;
  if (e >= 0) wake[(t & 1) * ne + e] = 0;
  return e;
}

}  // namespace tma

__global__ void __launch_bounds__(kTileCols)
    tma_tiles_kernel(const __grid_constant__ tma::Maps maps, float* A,
                     uint8_t* vis, int* ws, int H, int W, int k,
                     int max_rounds) {
  using namespace tma;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_entry, s_out;
  unsigned char* const slot =
      smem_raw + ((128 - (saddr(smem_raw) & 127)) & 127);
  const int nby = (H + TY - 1) / TY, nbx = (W + TX - 1) / TX;
  const int nt = nby * nbx, ne = 2 * nt;
  int* const wake = ws;
  int* const list = ws + 2 * ne;
  int* const ctl = ws + 4 * ne;
  const int th = threadIdx.x;
  const bool lead = blockIdx.x == 0 && th == 0;
  if (th == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t phase = 0;  // the parity the window's mbarrier completes next
  // where this block's time goes (thread 0's clock): see ctl 11..15
  const long long start = clock64();
  long long spent[4] = {0, 0, 0, 0};

  for (int t = 0;; ++t) {
    const int n = ld_cg(ctl + t % 3);  // the same in every block
    if (n == 0 || t >= max_rounds) {
      if (lead) ctl[9] = n == 0 ? 1 : 2;
      if (th == 0) {
        for (int q = 0; q < 4; ++q)
          atomicAdd(ctl + 11 + q, (int)(spent[q] >> 10));
        atomicAdd(ctl + 15, (int)((clock64() - start) >> 10));
      }
      return;
    }
    if (lead) {
      ctl[(t + 2) % 3] = 0;
      ctl[3 + (t + 2) % 3] = 0;
      ctl[10] = t + 1;
    }
    int* const next_wake = wake + ((t + 1) & 1) * ne;
    int* const next_list = list + ((t + 1) & 1) * ne;
    int* const next_n = ctl + (t + 1) % 3;
    // the last round's stores (generic proxy) before this round's boxes
    if (th == 0) asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (;;) {
      if (th == 0) {
        const int e = take(ctl, list, wake, t, n, ne);
        s_entry = e;
        s_out = 0;
        if (e >= 0) issue(maps, slot, &bar, e, nt, nbx, W);
      }
      __syncthreads();
      const int e = s_entry;
      if (e < 0) break;
      const bool vf = e >= nt;
      const int tile = vf ? e - nt : e;
      const int ti = tile / nbx, tj = tile - ti * nbx;
      const int r0 = ti * TY, c0 = tj * TX, c = c0 + th;
      const int rows = min(TY, H - r0);
      const long long c0_wait = clock64();
      mbar_wait(&bar, phase);
      phase ^= 1;
      const long long c1_sweep = clock64();
      spent[0] += c1_sweep - c0_wait;
      // at the dateline: the halo column over it, from a side box
      if (tj == 0 || tj == nbx - 1) {
        if (th < kRows) {
          if (!vf) {
            float* const b = reinterpret_cast<float*>(slot);
            const float* const wl = reinterpret_cast<float*>(slot + kOffWL);
            const float* const wr = reinterpret_cast<float*>(slot + kOffWR);
            if (tj == 0)
              b[th * kBoxA + kPadA - 1] = wl[th * kSideA + kSideA - 1];
            if (tj == nbx - 1)
              b[th * kBoxA + kPadA + W - c0] = wr[th * kSideA];
          } else {
            if (tj == 0)
              slot[th * kBoxV + kPadV - 1] =
                  slot[kOffWL + th * kSideV + kSideV - 1];
            if (tj == nbx - 1)
              slot[th * kBoxV + kPadV + W - c0] = slot[kOffWR + th * kSideV];
          }
        }
        __syncthreads();
      }
      const int* const sP = reinterpret_cast<const int*>(slot + kOffPacked);
      const float* const sArea =
          reinterpret_cast<const float*>(slot + kOffArea);
      volatile float* const sA = reinterpret_cast<float*>(slot);
      volatile uint8_t* const sV = slot;
      uint32_t touched = 0;
      int sweeps = 0;
      bool settled = false;  // the visit ended on a sweep that wrote nothing
      for (int it = 0; it < k; ++it) {
        bool ch = false;
        if (c < W) {
          for (int q = 0; q < rows; ++q) {
            const int li = (it & 1) ? rows - 1 - q : q;  // down, then up
            const int p = sP[li * TX + th];
            if (!vf) {
              const int m = p & 0xff;
              if (!m) continue;  // A = its area from the start
              const int ctr = (li + 1) * kBoxA + kPadA + th;
              // the eight loads first, all in flight at once, then the
              // sum in bit order (a chain of dependent loads was a visit's
              // latency)
              float nb[8];
#pragma unroll
              for (int b = 0; b < 8; ++b)
                nb[b] = sA[ctr + dyk(b) * kBoxA + dxk(b)];
              float acc = sArea[li * TX + th];
#pragma unroll
              for (int b = 0; b < 8; ++b)
                if ((m >> b) & 1) acc = __fadd_rn(acc, nb[b]);
              if (__float_as_int(acc) != __float_as_int(sA[ctr])) {
                sA[ctr] = acc;
                touched |= 1u << li;
                ch = true;
              }
            } else {
              const int o = (p >> 8) & 0xff;
              const int ctr = (li + 1) * kBoxV + kPadV + th;
              if (!o || sV[ctr]) continue;
              int any = 0;
#pragma unroll
              for (int b = 0; b < 8; ++b)
                any |= ((o >> b) & 1) & sV[ctr + dyk(b) * kBoxV + dxk(b)];
              if (any) {
                sV[ctr] = 1;
                touched |= 1u << li;
                ch = true;
              }
            }
          }
        }
        sweeps = it + 1;
        if (!__syncthreads_or(ch)) {  // the rest would write nothing
          settled = true;
          break;
        }
      }
      const long long c2_write = clock64();
      spent[1] += c2_write - c1_sweep;
      // the cells that changed (A only grows, vis only turns to 1); only
      // this entry writes them
      for (int li = 0; li < rows; ++li) {
        if (!((touched >> li) & 1)) continue;
        const long i = (long)(r0 + li) * W + c;
        if (!vf)
          __stcg(A + i, sA[(li + 1) * kBoxA + kPadA + th]);
        else
          vis[i] = 1;
      }
      if (touched) {  // what this column wrote of the border
        const bool top = touched & 1, bottom = (touched >> (rows - 1)) & 1;
        int bits = (top ? kTop : 0) | (bottom ? kBottom : 0);
        if (th == 0)
          bits |= kLeft | (top ? kTopLeft : 0) | (bottom ? kBottomLeft : 0);
        if (c == min(c0 + TX, W) - 1)
          bits |= kRight | (top ? kTopRight : 0) |
                  (bottom ? kBottomRight : 0);
        atomicOr(&s_out, bits);
      }
      if (__syncthreads_or(touched != 0)) {
        // each edge bit wakes the tile whose halo it faces, and a visit
        // that did not settle wakes itself
        const int base = vf ? nt : 0;
        if (th < 8)
          wake_facing(th, base, tile, s_out & 0xff, next_wake, next_list,
                      next_n, nby, nbx);
        if (th == 8 && !settled && atomicOr(next_wake + e, 1 << 8) == 0)
          next_list[atomicAdd(next_n, 1)] = e;
      }
      if (th == 0) {
        atomicAdd(ctl + 6, 1);
        atomicMax(ctl + 7, sweeps);
      }
      // the window's last reads before thread 0 issues the next boxes
      __syncthreads();
      spent[2] += clock64() - c2_write;
    }
    const long long c_sync = clock64();
    grid.sync();
    spent[3] += clock64() - c_sync;
  }
}

// ---------------------------------------------------------------------------
// K11c, the delta wave blocked in time (the design is in the header).
//
// Workspace (int32), ntw wave tiles and as many vis tiles (both K8's),
// ne = 2 ntw entries (entry e < ntw the wave on tile e, else vis on
// tile e - ntw):
//   edges [ne]      finish's edge bits of a vis entry's last visit
//   wake  [2][ne]   round t + 1's wake words, in slot (t + 1) & 1
//   list  [2][ne]   round t's entries, in slot t & 1 (the caller fills
//                   slot 0 with every entry in order)
//   live  [2][ntw]  the round of a wave tile's last nonzero output, in
//                   slot round & 1 (the caller sets slot 1 to -1, the
//                   area being every tile's output of "round -1", and
//                   slot 0 to -2)
//   ctl: 0..2 list lengths (slot 0 = ne), 3..5 walk counters, 6 wave
//        visits, 7 vis visits, 8 most passes of a vis visit, 9 some vis
//        visit wrote, 10 status (1 converged, 2 out of rounds), 11 rounds
//        run, 12 rounds with a wave visit, 13 the last sweep that left a
//        nonzero delta (the solve's sweep index, from 1), 14..15 unused,
//        16..21 the blocks' clock cycles / 1024, summed: loading wave
//        windows, sweeping them, writing A and delta out, vis visits, at
//        the grid syncs, and in all (the rest is taking entries)
// Everything else zero.  Round t reads delta from d0 when t is even, else
// from d1, and writes the other; d0 holds the area, d1 anything.
// ---------------------------------------------------------------------------

size_t wave_tile_smem(int k) {
  const size_t cells = (size_t)(kTileRows + 2 * k) * (kTileCols + 2 * k);
  const size_t wave = cells * (2 * sizeof(float) + 1);
  const size_t v = vis_smem<kTileRows, kTileCols>();
  return wave > v ? wave : v;
}

// 16 bytes from device memory by way of L2 (the buffers change between
// rounds, and L1 does not see other blocks' writes) to shared memory, or
// 16 zero bytes where `take` is false
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool take) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(take ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kTileCols)
    wave_tiles_kernel(const int* __restrict__ packed, float* A, uint8_t* vis,
                      float* d0, float* d1, int* ws, int H, int W, int k,
                      int max_rounds) {
  constexpr int TY = kTileRows, TX = kTileCols, VY = kTileRows;
  static_assert(TY <= 32, "a column's rows are one 32-bit mask");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out, entry;
  __shared__ int live3[3][3];  // the 3x3 tiles' last output: round t - 1's
  const int nbx = (W + TX - 1) / TX;
  const int nbyw = (H + TY - 1) / TY, ntw = nbyw * nbx;
  const int nbyv = (H + VY - 1) / VY, ne = ntw + nbyv * nbx;
  int* const edges = ws;
  int* const wake = ws + ne;
  int* const list = ws + 3 * ne;
  int* const live = ws + 5 * ne;
  int* const ctl = live + 2 * ntw;
  const int WH = TY + 2 * k, WW = TX + 2 * k, WQ = WW / 4;
  float* const buf0 = reinterpret_cast<float*>(smem);
  float* const buf1 = buf0 + WH * WW;
  uint8_t* const bits = reinterpret_cast<uint8_t*>(buf1 + WH * WW);
  const int th = threadIdx.x, lane = th & 31, warp = th >> 5;
  const bool lead = blockIdx.x == 0 && th == 0;
  // where this block's time goes (thread 0's clock): see ctl 16..21
  const long long start = clock64();
  long long spent[5] = {0, 0, 0, 0, 0};

  for (int t = 0;; ++t) {
    const int n = ld_cg(ctl + t % 3);  // the same in every block
    if (n == 0 || t >= max_rounds) {
      if (lead) ctl[10] = n == 0 ? 1 : 2;
      if (th == 0) {
        for (int q = 0; q < 5; ++q)
          atomicAdd(ctl + 16 + q, (int)(spent[q] >> 10));
        atomicAdd(ctl + 21, (int)((clock64() - start) >> 10));
      }
      return;
    }
    if (lead) {
      ctl[(t + 2) % 3] = 0;
      ctl[3 + (t + 2) % 3] = 0;
      ctl[11] = t + 1;
    }
    const float* const dcur = (t & 1) ? d1 : d0;
    float* const dnext = (t & 1) ? d0 : d1;
    int* const next_wake = wake + ((t + 1) & 1) * ne;
    int* const next_list = list + ((t + 1) & 1) * ne;
    int* const next_n = ctl + (t + 1) % 3;
    for (;;) {
      if (th == 0) {
        const int j = atomicAdd(ctl + 3 + t % 3, 1);
        entry = j < n ? ld_cg(list + (t & 1) * ne + j) : -1;
        if (entry >= 0) wake[(t & 1) * ne + entry] = 0;
        out = 0;
      }
      __syncthreads();
      const int e = entry;
      if (e < 0) break;
      const long long c_visit = clock64();
      if (e >= ntw) {  // vis: K11b's vis entry on K8's tile
        const int tl = e - ntw, ti = tl / nbx, tj = tl - ti * nbx;
        const int r0 = ti * VY, c0 = tj * TX;
        int passes;
        const uint64_t wrote = vis_visit<VY, TX>(smem, packed, vis, 0, r0,
                                                 c0, H, W, &passes);
        finish<VY, TX>(wrote, c0 + th, r0, c0, H, W, &out, edges, ctl + 7,
                       0, passes, e);
        // finish's barrier has made `out` whole: eight threads push it
        if (th < 8)
          wake_facing(th, ntw, tl, out & 0xff, next_wake, next_list, next_n,
                      nbyv, nbx);
        __syncthreads();  // before thread 0 takes the next entry
        spent[3] += clock64() - c_visit;
        continue;
      }
      // the wave on tile e
      const int ti = e / nbx, tj = e - ti * nbx;
      const int r0 = ti * TY, c0 = tj * TX, c = c0 + th;
      const int rows = min(TY, H - r0);
      const bool col = c < W;
      if (th < 9) {
        const int ii = ti + th / 3 - 1;
        live3[th / 3][th % 3] =
            ii >= 0 && ii < nbyw &&
            ld_cg(live + ((t - 1) & 1) * ntw + ii * nbx +
                  (tj + th % 3 - 1 + nbx) % nbx) == t - 1;
      }
      __syncthreads();
      // the window: rows r0 - k .., columns c0 - k .. (x wraps), 4
      // columns a copy (W and k are multiples of 4, so a copy lies in one
      // tile and on one side of the dateline); the region of a tile whose
      // last output is not round t - 1's reads zeros
      for (int idx = th; idx < WH * WQ; idx += TX) {
        const int wi = idx / WQ, wj = (idx - wi * WQ) * 4;
        const int r = r0 - k + wi;
        int cc = (c0 - k + wj) % W;
        if (cc < 0) cc += W;
        const bool in = r >= 0 && r < H;
        const int tc = cc / TX;
        const int dj = tc == tj ? 1 : (tc == (tj + 1) % nbx ? 2 : 0);
        const long g = in ? (long)r * W + cc : 0;
        copy16(buf0 + wi * WW + wj, dcur + g,
               in && live3[r / TY - ti + 1][dj]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          bits[wi * WW + wj + u] =
              in ? (uint8_t)(__ldg(packed + g + u) & 0xff) : 0;
      }
      // this thread's column of the tile: A in registers
      float acc[TY];
#pragma unroll
      for (int li = 0; li < TY; ++li)
        acc[li] = col && li < rows ? __ldcg(A + (long)(r0 + li) * W + c)
                                   : 0.0f;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      const long long c_sweep = clock64();
      spent[0] += c_sweep - c_visit;
      float* cur = buf0;
      float* nxt = buf1;
      uint32_t moved = 0;
      int last = 0;
      for (int s = 1; s <= k; ++s) {
        // d_s on the cells s inside the window, from d_{s-1}: the bits in
        // order, from 0.0f, as the twin adds them
        for (int i = s + warp; i < WH - s; i += TX / 32) {
          for (int j = s + lane; j < WW - s; j += 32) {
            const int m = bits[i * WW + j];
            float nb[8];  // every load in flight, then the sum
#pragma unroll
            for (int b = 0; b < 8; ++b)
              nb[b] = cur[(i + dyk(b)) * WW + j + dxk(b)];
            float d = 0.0f;
#pragma unroll
            for (int b = 0; b < 8; ++b)
              if ((m >> b) & 1) d = __fadd_rn(d, nb[b]);
            nxt[i * WW + j] = d;
          }
        }
        __syncthreads();
        // the tile's cells add d_s in sweep order (adding 0 leaves A)
        bool any = false;
#pragma unroll
        for (int li = 0; li < TY; ++li) {
          const float d = nxt[(k + li) * WW + k + th];
          if (col && li < rows && d != 0.0f) {
            acc[li] = __fadd_rn(acc[li], d);
            moved |= 1u << li;
            any = true;
          }
        }
        if (__syncthreads_or(any)) last = s;
        float* const tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
      const long long c_write = clock64();
      spent[1] += c_write - c_sweep;
      // d_k out where the tile's is not all zero; A where it moved
      bool nz = false;
      for (int li = 0; li < rows; ++li)
        nz |= col && cur[(k + li) * WW + k + th] != 0.0f;
      const bool tile_nz = __syncthreads_or(nz);
      if (col) {
        if (tile_nz)
          for (int li = 0; li < rows; ++li)
            __stcg(dnext + (long)(r0 + li) * W + c,
                   cur[(k + li) * WW + k + th]);
#pragma unroll
        for (int li = 0; li < TY; ++li)
          if ((moved >> li) & 1)
            __stcg(A + (long)(r0 + li) * W + c, acc[li]);
      }
      if (th == 0) {
        atomicAdd(ctl + 6, 1);
        atomicMax(ctl + 12, t + 1);
        if (last) atomicMax(ctl + 13, t * k + last);
        if (tile_nz) live[(t & 1) * ntw + e] = t;
      }
      if (tile_nz && th < 9) {  // the 3x3 neighbourhood's wave entries
        const int ii = ti + th / 3 - 1;
        if (ii >= 0 && ii < nbyw) {
          const int nb = ii * nbx + (tj + th % 3 - 1 + nbx) % nbx;
          if (atomicOr(next_wake + nb, 1) == 0)
            next_list[atomicAdd(next_n, 1)] = nb;
        }
      }
      __syncthreads();  // before thread 0 takes the next entry
      spent[2] += clock64() - c_write;
    }
    const long long c_sync = clock64();
    grid.sync();
    spent[4] += clock64() - c_sync;
  }
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// -lcuda at link time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the tensor map of a row-major H x W field of `elem`-byte cells, in boxes
// of bw x bh cells; cells beyond the grid read 0
bool tensor_map(EncodeTiled encode, CUtensorMap* map,
                CUtensorMapDataType type, const void* base, int W, int H,
                int elem, int bw, int bh) {
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t stride[1] = {(cuuint64_t)W * elem};
  const cuuint32_t boxdim[2] = {(cuuint32_t)bw, (cuuint32_t)bh};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, stride, boxdim,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// K11d: one round on cluster windows, one launch: the nact bands listed
// in `bands` (host memory), nseg segments of seg columns each (the plan
// banded::accepted checks, else cudaErrorInvalidValue); flags (zeroed)
// gets bit 0 if band b changed, bit 1 if within k rows of its low edge,
// bit 2 of its high edge, then the clusters that ran, the most sweeps a
// window ran and the blocks' cycles; next_flags (nb + kFlagWords words) is
// zeroed for the next round.
int demiurge_flow_banded_cluster(const int* packed, const float* area,
                                 float* A, uint8_t* vis, int* flags,
                                 int* next_flags, const int* bands_host,
                                 int nact, int H, int W, int band, int k,
                                 int cluster, int nseg, int seg,
                                 void* stream) {
  if (!banded::accepted(H, W, band, k, cluster, nseg, seg) || nact < 1 ||
      nact > kMaxBands || (long)nact * nseg > 65535)
    return (int)cudaErrorInvalidValue;
  BandList list;
  for (int a = 0; a < nact; ++a) {
    if (bands_host[a] < 0 || bands_host[a] >= H / band)
      return (int)cudaErrorInvalidValue;
    list.band[a] = (unsigned short)bands_host[a];
  }
  const int ww = nseg == 1 ? W : seg + 2 * k;
  const size_t smem =
      banded::smem(band + 2 * k, banded::slice(ww, cluster));
  return (int)bands::launch(banded_cluster_kernel, banded::kThreads, cluster,
                            nact * nseg, smem, (cudaStream_t)stream, packed,
                            area, A, vis, flags, next_flags, H, W, band, k,
                            nseg, seg, list);
}

// K11d: how many clusters of `cluster` blocks, `smem` bytes each, the card
// holds at once.
int demiurge_flow_banded_cluster_clusters(int cluster, int smem) {
  return bands::max_clusters(banded_cluster_kernel, banded::kThreads,
                             cluster, (size_t)smem);
}

// K11d's earlier design (the yardstick): one round, k in-place sweeps of
// (A, vis), one launch each, over the rows of the nact bands listed in
// `bands` (host memory); flags[b] (zeroed here) gets bit 0 if band b
// changed, bit 1 if within k rows of its low edge, bit 2 of its high edge.
int demiurge_flow_banded_sweeps(const int* packed, const float* area,
                                float* A, uint8_t* vis, int* flags,
                                const int* bands, int nact, int H, int W,
                                int band, int k, void* stream) {
  if (nact < 1 || nact > kMaxBands || nact * band > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (H / band), st);
  if (err != cudaSuccess) return (int)err;
  BandList list;
  for (int a = 0; a < nact; ++a) list.band[a] = (unsigned short)bands[a];
  const dim3 grid((W + kBlockX - 1) / kBlockX, nact * band);
  for (int s = 0; s < k; ++s) {
    banded_sweep_kernel<<<grid, kBlockX, 0, st>>>(packed, area, A, vis, flags,
                                                  W, band, k, list);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K11a: one round: act from prev (3x3 tile neighbourhoods), cur zeroed,
// then k in-place sweeps of the active tiles, each setting cur[tile] = 1
// where it wrote.
int demiurge_flow_tiles_round(const int* packed, const float* area, float* A,
                              uint8_t* vis, const int* prev, int* cur,
                              int* act, int H, int W, int ty, int tx, int k,
                              void* stream) {
  if (tx % kBlockX != 0 || W % tx != 0 || H % ty != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nby = H / ty, nbx = W / tx, nt = nby * nbx;
  cudaError_t err = cudaMemsetAsync(cur, 0, sizeof(int) * nt, st);
  if (err != cudaSuccess) return (int)err;
  tile_activity_kernel<<<(nt + 255) / 256, 256, 0, st>>>(prev, act, nby, nbx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W / kBlockX, H);
  for (int s = 0; s < k; ++s) {
    tile_sweep_kernel<<<grid, kBlockX, 0, st>>>(packed, area, A, vis, act, cur,
                                                W, ty, tx, nbx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K11c: n sweeps of the wave; sweep j (the solve's sweep first + j) reads
// delta from d0 when that index is even, else from d1, and writes the
// other; flags[j] = 1 if it moved delta or vis (the caller zeroes flags).
int demiurge_flow_wave_sweeps(const int* packed, float* d0, float* d1,
                              float* A, uint8_t* vis, int* flags, int H,
                              int W, int first, int n, void* stream) {
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  for (int j = 0; j < n; ++j) {
    const bool odd = (first + j) & 1;
    wave_sweep_kernel<<<grid, kBlockX, 0, (cudaStream_t)stream>>>(
        packed, odd ? d1 : d0, odd ? d0 : d1, A, vis, flags + j, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K11b: the whole solve in one persistent cooperative launch on as many
// blocks as the card holds at once, at most one an entry (written to
// *blocks); ws as described above; mode 0 both, 1 A, 2 vis.  (ty, tx) must
// be the built tile, else cudaErrorInvalidValue.
int demiurge_flow_fused(const int* packed, const float* area, float* A,
                        uint8_t* vis, int* ws, int H, int W, int ty, int tx,
                        int mode, int max_rounds, int* blocks,
                        void* stream) {
  if (ty != kTileRows || tx != kTileCols || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      mode == kBoth ? (const void*)fused_tiles_kernel<kBoth>
                    : (mode == kOnlyA ? (const void*)fused_tiles_kernel<kOnlyA>
                                      : (const void*)fused_tiles_kernel<
                                            kOnlyVis>);
  const size_t smem = mode == kBoth ? fused_tile_smem<kBoth>()
                                    : (mode == kOnlyA
                                           ? fused_tile_smem<kOnlyA>()
                                           : fused_tile_smem<kOnlyVis>());
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTileCols, smem);
  if (err != cudaSuccess) return (int)err;
  const int ne = (mode == kBoth ? 2 : 1) * ((H + ty - 1) / ty) *
                 ((W + tx - 1) / tx);
  *blocks = per_sm * sms < ne ? per_sm * sms : ne;
  void* args[] = {&packed, &area, &A, &vis, &ws, &H, &W, &max_rounds};
  err = cudaLaunchCooperativeKernel(kernel, dim3(*blocks), dim3(kTileCols),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The earlier K11b (the yardstick): the solve in one cooperative launch of
// band windows, one pixel a thread, on as many blocks as fit on the card at
// once (written to *blocks); ws as described at fused_bands_kernel.
int demiurge_flow_fused_bands(const int* packed, const float* area, float* A,
                              uint8_t* vis, int* ws, int H, int W, int band,
                              int k, int narrow, int mode, int max_rounds,
                              int* blocks, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_bands_kernel, kFusedThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  void* args[] = {&packed, &area, &A,      &vis,  &ws,         &H,
                  &W,      &band, &k,      &narrow, &mode, &max_rounds};
  err = cudaLaunchCooperativeKernel((const void*)fused_bands_kernel,
                                    dim3(*blocks), dim3(kFusedThreads), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// K11a on TMA windows: the whole (A, vis) solve in one persistent
// cooperative launch of 128-thread blocks, as many as fit on the card at
// once, at most one an entry (written to *blocks); ws as described at
// tma_tiles_kernel; k in-place sweeps a visit.  (ty, tx) must be the
// built tile and W a multiple of 16 (a row of vis is whole 16-byte units
// for the tensor maps), else cudaErrorInvalidValue.
int demiurge_flow_2d_tma(const int* packed, const float* area, float* A,
                         uint8_t* vis, int* ws, int H, int W, int ty, int tx,
                         int k, int max_rounds, int* blocks, void* stream) {
  using namespace tma;
  if (ty != TY || tx != TX || W % 16 != 0 || k < 1)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  Maps maps;
  if (!tensor_map(encode, &maps.A, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, W, H,
                  4, kBoxA, kRows) ||
      !tensor_map(encode, &maps.A_side, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A,
                  W, H, 4, kSideA, kRows) ||
      !tensor_map(encode, &maps.vis, CU_TENSOR_MAP_DATA_TYPE_UINT8, vis, W,
                  H, 1, kBoxV, kRows) ||
      !tensor_map(encode, &maps.vis_side, CU_TENSOR_MAP_DATA_TYPE_UINT8, vis,
                  W, H, 1, kSideV, kRows) ||
      !tensor_map(encode, &maps.packed, CU_TENSOR_MAP_DATA_TYPE_INT32, packed,
                  W, H, 4, TX, TY) ||
      !tensor_map(encode, &maps.area, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, area,
                  W, H, 4, TX, TY))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)tma_tiles_kernel;
  int device = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, TX,
                                                        kSmem);
  if (err != cudaSuccess) return (int)err;
  const int ne = 2 * ((H + TY - 1) / TY) * ((W + TX - 1) / TX);
  *blocks = fit * sms < ne ? fit * sms : ne;
  void* args[] = {&maps, &A, &vis, &ws, &H, &W, &k, &max_rounds};
  err = cudaLaunchCooperativeKernel(kernel, dim3(*blocks), dim3(TX), args,
                                    kSmem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K11c blocked in time: the wave on K8's tiles (k sweeps a round, k a
// multiple of 4 in [4, 16], W a multiple of 4, and k at most the ragged
// last tile column's width where there are more than three tile columns,
// so a window stays in its 3x3 tiles) beside K8's vis entries, in one
// persistent cooperative launch on as many blocks as the card holds at
// once, at most one an entry (written to *blocks); ws, d0 and d1 as
// described at wave_tiles_kernel.  (ty, tx) must be the built tile, else
// cudaErrorInvalidValue.
int demiurge_flow_wave_tiles(const int* packed, float* A, uint8_t* vis,
                             float* d0, float* d1, int* ws, int H, int W,
                             int ty, int tx, int k, int max_rounds,
                             int* blocks, void* stream) {
  const int nbx = (W + tx - 1) / tx;
  if (ty != kTileRows || tx != kTileCols || k < 4 || k > ty || k % 4 != 0 ||
      W % 4 != 0 || (W % tx != 0 && W % tx < k && nbx > 3))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)wave_tiles_kernel;
  const size_t smem = wave_tile_smem(k);
  int device = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, tx,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int ne = 2 * ((H + ty - 1) / ty) * nbx;
  *blocks = fit * sms < ne ? fit * sms : ne;
  void* args[] = {&packed, &A, &vis, &d0, &d1, &ws, &H, &W, &k, &max_rounds};
  err = cudaLaunchCooperativeKernel(kernel, dim3(*blocks), dim3(tx), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

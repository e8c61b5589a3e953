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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K7, K8 and K10: shared-memory tiles solved to a local fixpoint, quiet
// tiles skipped.
// ---------------------------------------------------------------------------

// NEIGHBORS_FLOW_ORDER as compile-time offsets
__host__ __device__ constexpr int dxk(int k) {
  return (k == 0 || k == 3 || k == 5) ? 1 : ((k == 1 || k == 6) ? 0 : -1);
}
__host__ __device__ constexpr int dyk(int k) {
  return k < 3 ? 1 : (k < 5 ? 0 : -1);
}

constexpr int kFeed = 1 << 8;  // a change of this cell feeds its own row
constexpr int kReal = 1 << 9;  // a cell of the grid (edge tiles are ragged)
constexpr int kRowOut = (1 << 3) | (1 << 4);  // the dy = 0 neighbours
constexpr int kNegOut = (1 << 5) | (1 << 6) | (1 << 7);  // out bits, dy = -1
constexpr int kPosOut = (1 << 0) | (1 << 1) | (1 << 2);  // out bits, dy = +1

// K10: whether a cell of band row rl with out bits `out` leaves its band
__device__ __forceinline__ bool crossing(int out, int rl, int band) {
  return (rl == 0 && (out & kNegOut)) || (rl == band - 1 && (out & kPosOut));
}

// a tile's edge bits: what it wrote of its border
constexpr int kTop = 1, kBottom = 2, kLeft = 4, kRight = 8;
constexpr int kTopLeft = 16, kTopRight = 32, kBottomLeft = 64,
              kBottomRight = 128;

// stats: [0] tile visits, [1] most passes of a visit, [2 + j] round j of
// the batch wrote
constexpr int kStatsHead = 2;

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ uint8_t ld_cg(const uint8_t* p) {
  return __ldcg(p);
}
__device__ __forceinline__ int ld_cg(const int* p) { return __ldcg(p); }

// Step 1: whether a neighbour tile wrote a cell of this tile's halo last
// round; a quiet block clears its own bits for this round.  Also zeroes
// the block's edge bits *out.
__device__ bool tile_awake(const int* __restrict__ prev, int* cur, int nby,
                           int nbx, int* out) {
  __shared__ int awake;
  if (threadIdx.x == 0) {
    const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
    auto bits = [&](int di, int dj) {  // y clips, x wraps
      const int ii = ti + di;
      return ii < 0 || ii >= nby ? 0 : prev[ii * nbx + (tj + dj + nbx) % nbx];
    };
    const int a = (bits(-1, 0) & kBottom) | (bits(1, 0) & kTop) |
                  (bits(0, -1) & kRight) | (bits(0, 1) & kLeft) |
                  (bits(-1, -1) & kBottomRight) | (bits(-1, 1) & kBottomLeft) |
                  (bits(1, -1) & kTopRight) | (bits(1, 1) & kTopLeft);
    awake = a;
    *out = 0;
    if (!a) cur[blockIdx.x] = 0;
  }
  __syncthreads();
  return awake != 0;
}

// Step 2, the halo'd field: (TY + 2) x (TX + 2) cells from row r0 - 1 and
// column c0 - 1, x periodic, rows beyond the grid 0.
template <int TY, int TX, typename T>
__device__ void load_halo(volatile T* s, const T* g, int r0, int c0, int H,
                          int W) {
  constexpr int SW = TX + 2;
  for (int k = threadIdx.x; k < (TY + 2) * SW; k += TX) {
    const int li = k / SW, lj = k - (k / SW) * SW;
    const int r = r0 + li - 1;
    int c = (c0 + lj - 1) % W;
    if (c < 0) c += W;
    s[k] = (r >= 0 && r < H) ? ld_cg(g + (long)r * W + c) : T(0);
  }
}

// K7's step 3: passes over the dirty rows until no row is dirty.
// cell(li) updates this thread's cell of row li and returns 0 (no change),
// 1 (changed) or 3 (changed, and it feeds its own row).  Each warp walks
// its own strip of 32 columns with a warp-uniform dirty mask: a row is
// computed, and repeated while a change fed its own row, which leaves the
// row satisfied in the strip; a change makes the rows above and below
// dirty (in a down pass the row below is next).  A change in a strip's
// edge column marks the neighbour strip's rows around it in a shared mask,
// which the neighbour pulls when the block meets at the end of the pass.
// A row that is not dirty satisfies its equations, so no
// dirty row in any strip means the tile's local fixpoint.  Returns the
// rows where this thread's cell changed; *passes gets the passes taken.
template <int TY, int TX, typename Cell>
__device__ uint64_t relax(Cell cell, int* passes) {
  static_assert(TY <= 64, "a thread's rows are one 64-bit mask");
  static_assert(TX % 32 == 0, "whole warps");
  constexpr int NW = TX / 32;
  __shared__ unsigned long long marks[NW];
  if (threadIdx.x < NW) marks[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const uint64_t all = TY == 64 ? ~0ull : (1ull << TY) - 1;
  auto around = [](int li) {  // rows li - 1, li, li + 1 of the tile
    return (li > 0 ? 1ull << (li - 1) : 0) | 1ull << li |
           (li + 1 < TY ? 1ull << (li + 1) : 0);
  };
  uint64_t dirty = all, touched = 0;
  for (int p = 0;; ++p) {
    const bool down = (p & 1) == 0;
    for (int s = 0; s < TY; ++s) {
      const int li = down ? s : TY - 1 - s;
      if (!((dirty >> li) & 1)) continue;  // uniform over the warp
      dirty &= ~(1ull << li);
      for (int reps = 0;; ++reps) {
        const int r = cell(li);
        if (r) touched |= 1ull << li;
        const unsigned changed = __ballot_sync(~0u, r & 1);
        if (changed) dirty |= around(li) & ~(1ull << li);
        if (lane == 0 && (changed & 1u) && w > 0)
          atomicOr(&marks[w - 1], (unsigned long long)around(li));
        if (lane == 0 && (changed >> 31) && w < NW - 1)
          atomicOr(&marks[w + 1], (unsigned long long)around(li));
        if (!__any_sync(~0u, r & 2)) break;
        if (reps == TX) {  // capped: the row stays dirty
          dirty |= 1ull << li;
          break;
        }
      }
    }
    __syncthreads();  // every strip's marks of this pass are in
    if (lane == 0) dirty |= atomicExch(&marks[w], 0ull);
    dirty = __shfl_sync(~0u, dirty, 0);
    if (!__syncthreads_or(dirty != 0) || p + 1 >= TY * TX) {
      *passes = p + 1;
      return touched;
    }
  }
}

// Step 4's bookkeeping: the edge bits of the rows `wrote` of this thread's
// column c, OR-ed over the block into *out; thread 0 then publishes them.
template <int TY, int TX>
__device__ void finish(uint64_t wrote, int c, int r0, int c0, int H, int W,
                       int* out, int* cur, int* stats, int slot,
                       int passes) {
  if (wrote) {
    const bool top = wrote & 1;
    const bool bottom = (wrote >> (min(TY, H - r0) - 1)) & 1;
    int bits = (top ? kTop : 0) | (bottom ? kBottom : 0);
    if (c == c0)
      bits |= kLeft | (top ? kTopLeft : 0) | (bottom ? kBottomLeft : 0);
    if (c == min(c0 + TX, W) - 1)
      bits |= kRight | (top ? kTopRight : 0) | (bottom ? kBottomRight : 0);
    atomicOr(out, bits | (1 << 8));
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  cur[blockIdx.x] = *out & 0xff;
  atomicAdd(stats, 1);
  atomicMax(stats + 1, passes);
  if (*out) atomicOr(stats + kStatsHead + slot, 1);
}

template <int TY, int TX>
constexpr size_t area_smem() {
  return sizeof(float) * ((TY + 2) * (TX + 2) + TY * TX) +
         sizeof(uint16_t) * TY * TX;
}

template <int TY, int TX>
constexpr size_t vis_smem() {
  return ((TY + 2) * (TX + 2) + 15) / 16 * 16 +
         sizeof(int16_t) * (TY + 2) * (TX + 2);
}

template <int TY, int TX>
constexpr size_t exit_smem() {
  return (sizeof(int) + sizeof(int16_t)) * (TY + 2) * (TX + 2);
}

template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    area_tile_kernel(const int* __restrict__ packed,
                     const float* __restrict__ area, float* A,
                     const int* __restrict__ prev, int* cur, int* stats,
                     int slot, int H, int W, int nby, int nbx) {
  constexpr int SW = TX + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  volatile float* sA = reinterpret_cast<float*>(smem);
  float* sArea = reinterpret_cast<float*>(smem) + (TY + 2) * SW;
  uint16_t* sMeta = reinterpret_cast<uint16_t*>(sArea + TY * TX);
  if (!tile_awake(prev, cur, nby, nbx, &out)) return;

  const int t = threadIdx.x;
  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX, c = c0 + t;
  load_halo<TY, TX>(sA, A, r0, c0, H, W);
  for (int li = 0; li < TY; ++li) {
    int m = 0;
    float ar = 0.0f;
    if (c < W && r0 + li < H) {
      const long i = (long)(r0 + li) * W + c;
      const int p = __ldg(packed + i);
      m = kReal | (p & 0xff) | ((p >> 8) & kRowOut ? kFeed : 0);
      ar = __ldg(area + i);
    }
    sMeta[li * TX + t] = (uint16_t)m;
    sArea[li * TX + t] = ar;
  }
  // (relax's barrier orders these stores before the first pass)

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
            acc = __fadd_rn(acc, sA[ctr + dyk(k) * SW + dxk(k)]);
        if (__float_as_int(acc) == __float_as_int(sA[ctr])) return 0;
        sA[ctr] = acc;
        return m & kFeed ? 3 : 1;
      },
      &passes);

  uint64_t wrote = 0;
  for (int li = 0; li < TY; ++li) {
    if (!((touched >> li) & 1)) continue;
    const long i = (long)(r0 + li) * W + c;
    const float v = sA[(li + 1) * SW + t + 1];
    if (__float_as_int(v) != __float_as_int(__ldcg(A + i))) {
      __stcg(A + i, v);
      wrote |= 1ull << li;
    }
  }
  finish<TY, TX>(wrote, c, r0, c0, H, W, &out, cur, stats, slot, passes);
}

// The pointers of a halo'd tile (sNext: cell -> a cell further down its
// path): every cell at itself, then each cell of the grid at its target
// unless is_end(out bits, row, tile row).  is_end sees every cell of the
// grid and may set its value; a cell without an out bit is an end
// whatever it returns, and so are the halo cells and the tile's cells
// beyond the grid.
template <int TY, int TX, typename End>
__device__ void point_down(volatile int16_t* sNext, const int* packed,
                           int r0, int c, int H, int W, End is_end) {
  constexpr int SW = TX + 2, SN = (TY + 2) * SW;
  const int t = threadIdx.x;
  for (int k = t; k < SN; k += TX) sNext[k] = (int16_t)k;
  __syncthreads();
  for (int li = 0; li < TY; ++li) {
    if (c >= W || r0 + li >= H) continue;
    const int o = (__ldg(packed + (long)(r0 + li) * W + c) >> 8) & 0xff;
    if (is_end(o, r0 + li, li) || !o) continue;
    const int k = __ffs(o) - 1, q = (li + 1) * SW + t + 1;
    sNext[q] = (int16_t)(q + dyk(k) * SW + dxk(k));
  }
  __syncthreads();
}

// K8's step 3: each cell of the halo'd tile points at a cell further down
// its path (at first its target; a sink, a halo cell or a cell beyond the
// grid at itself, and for K10b a crossing cell), and the pointers jump
// (next = next of next) until a cell reaches a 1 or points at an end.  In
// place: a pointer read at any time points further down the same path, and
// a cell only turns to 1 from a 1 on its path.  A pass that changes
// nothing leaves every cell either 1 or pointing at an end that holds 0:
// the tile's local fixpoint, in about log2 of its longest path passes.
// band == 0 is K8 (no crossing cells); band > 0 is K10b, whose crossing
// cells are ends and keep the seed they start from.
template <int TY, int TX>
__global__ void __launch_bounds__(TX)
    vis_tile_kernel(const int* __restrict__ packed, uint8_t* vis, int band,
                    const int* __restrict__ prev, int* cur, int* stats,
                    int slot, int H, int W, int nby, int nbx) {
  constexpr int SW = TX + 2, SN = (TY + 2) * SW;
  static_assert(TY <= 64, "a thread's rows are one 64-bit mask");
  static_assert(SN <= 32767, "a halo'd tile's cells are int16 indices");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int out;
  volatile uint8_t* sV = smem;
  volatile int16_t* sNext =
      reinterpret_cast<int16_t*>(smem + (SN + 15) / 16 * 16);
  if (!tile_awake(prev, cur, nby, nbx, &out)) return;

  const int t = threadIdx.x;
  const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
  const int r0 = ti * TY, c0 = tj * TX, c = c0 + t;
  load_halo<TY, TX>(sV, vis, r0, c0, H, W);
  point_down<TY, TX>(sNext, packed, r0, c, H, W, [&](int o, int r, int) {
    return band > 0 && crossing(o, r % band, band);
  });

  uint64_t touched = 0;
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

  // a touched cell went from 0 to 1, and only this block writes it
  for (int li = 0; li < TY; ++li)
    if ((touched >> li) & 1) vis[(long)(r0 + li) * W + c] = 1;
  finish<TY, TX>(touched, c, r0, c0, H, W, &out, cur, stats, slot, passes);
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

// n rounds, the first of them the solve's round `first`: round t reads the
// tiles' edge bits flags[(t % 2) * nt ..] and writes flags[((t + 1) % 2) *
// nt ..].
template <typename Kernel, typename... Args>
int tile_rounds(Kernel kernel, size_t smem, int ty, int tx, int* flags,
                int* stats, int H, int W, int first, int n,
                cudaStream_t st, Args... args) {
  const int nby = (H + ty - 1) / ty, nbx = (W + tx - 1) / tx;
  const int nt = nby * nbx;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(stats + kStatsHead, 0, sizeof(int) * n, st);
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < n; ++j) {
    const int t = first + j;
    kernel<<<nt, tx, smem, st>>>(args..., flags + (t & 1) * nt,
                                 flags + ((t + 1) & 1) * nt, stats, j, H, W,
                                 nby, nbx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K7's, K8's and K10's tile: rows, columns = threads a block (PERF.md has
// the shapes raced)
constexpr int kTileRows = 16, kTileCols = 128;

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

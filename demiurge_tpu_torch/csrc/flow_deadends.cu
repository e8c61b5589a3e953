// The reference's alternative flow solvers, for Hopper (sm_90a): the same
// (A, vis) fixpoint as csrc/flow.cu (K7/K8), reached four other ways.
//
// Replaces:
//   - K11d  tools/flow_rounds.py main (:24), whose kernel is
//           demiurge_tpu/pallas_kernels/flow.py _kernel (:83): banded rounds
//           of k sweeps with 3-bit band flags, read by the host every round;
//   - K11a  attic/flow_deadends.py flow_solve_pallas_2d (:115, _kernel2d
//           :34): 2-D tiles that skip when their 3x3 tile neighbourhood was
//           quiet last round;
//   - K11b  attic/flow_deadends.py flow_solve_fused (:319, _kernel_fused
//           :182): the whole solve in one launch with the stop test on the
//           device.  Here on K7/K8's tiles (below); the TPU design's band
//           windows, k sweeps a round and narrow windows go;
//   - K11c  attic/flow_deadends.py flow_solve_wave (:804, _kernel_wave
//           :534): the delta wave.
//
// Over the packed masks (kernels/flow.py pack_masks: bits 0..7 incoming,
// 8..15 outgoing, 16 mouth; neighbour i at NEIGHBORS_FLOW_ORDER[i], x
// periodic, out-of-range rows already masked off) a sweep of a cell is, in
// place, one thread per pixel, as in K7/K8:
//     A[p]   = area[p] + sum_{i in scan order, inc_i} A[neighbour_i]
//     vis[p] = vis[p] | OR_i (out_i & vis[neighbour_i])
// and writes only when its bits change.
//
// Why skipping is sound under in-place sweeps (K11a, d, and the earlier
// K11b kept as the yardstick, demiurge_flow_fused_bands).  Concurrent
// blocks see each other's writes within a sweep, so how far a change
// travels in one sweep is not bounded; the skip rules below do not rely on
// such a bound.  Let D_t be the cells written in round t and S_{t+1} the
// cells that round t+1 sweeps.  Each rule puts every cell with a neighbour
// (or itself) in D_t into S_{t+1}:
//   - K11d: band b runs if it changed (bit 0), if band b-1 changed within
//     k >= 1 rows of its high edge (bit 2) or band b+1 within k rows of its
//     low edge (bit 1), and a cell's neighbours lie in its own row band or
//     in the facing edge row of the next one;
//   - K11a: a tile runs if a tile of its 3x3 tile neighbourhood (x wraps,
//     y clips) changed; tiles are at least one cell wide;
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
// K11c is not in place for the wave: delta must be delivered exactly once,
// so delta lives in ping-pong buffers (Jacobi), A accumulates the new
// delta in place, and vis is K8's in-place OR sweep.  A sweep that leaves
// delta at exactly zero everywhere and vis unchanged certifies both
// fixpoints (the relaxation is nilpotent, so delta reaches exact zeros).
// Its A adds arrivals in hop order, another float32 sum than K7's.
//
// Bound on this card: device-memory bytes, as K7: read the masks, the area
// and write A and vis once (about 19 bytes a pixel); the sweeps stay in the
// 50 MB L2 at 2048x1024.  The designs test the reference's answers to the
// sweep count: tile and band skipping (K11a, K11d), one launch with the
// stop test on the device (K11b), and a wave that touches only what moved
// (K11c, which here still sweeps every pixel).
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
#include <cuda_runtime.h>
#include <stdint.h>

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
// K11d: a round of k sweeps over the rows of the bands the host listed.
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

}  // namespace

extern "C" {

// K11d: one round, k in-place sweeps of (A, vis) over the rows of the nact
// bands listed in `bands` (host memory); flags[b] (zeroed here) gets bit 0
// if band b changed, bit 1 if within k rows of its low edge, bit 2 of its
// high edge.
int demiurge_flow_banded_round(const int* packed, const float* area, float* A,
                               uint8_t* vis, int* flags, const int* bands,
                               int nact, int H, int W, int band, int k,
                               void* stream) {
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

}  // extern "C"

// The shared-memory tile machinery of the flow fixpoints: K7, K8 and
// K10 (csrc/flow.cu) and the tiled K12 (csrc/lakeflow.cu).  The design
// and the argument that a round which writes nothing certifies the
// fixpoint are in the header of csrc/flow.cu; csrc/lakeflow.cu extends
// them to the lake connections' remote reads.

#pragma once

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
// round, or (where `wake` is given: K12's word a tile, which another
// tile's write of a cell this one reads remotely set last round) the
// block's wake word is set; the block clears that word for the round
// after next, and a quiet block clears its own bits for this round.  Also
// zeroes the block's edge bits *out.  Returns what woke the tile (0:
// nothing): the neighbours' edge bits that face it (kBottom from the tile
// above, kTop from the one below, kRight from the left, kLeft from the
// right, kBottomRight from the upper left, and so on) and the wake word.
__device__ int tile_awake(const int* prev, int* cur, int nby, int nbx,
                          int* out, int* wake = nullptr) {
  __shared__ int awake;
  if (threadIdx.x == 0) {
    const int ti = blockIdx.x / nbx, tj = blockIdx.x - ti * nbx;
    auto bits = [&](int di, int dj) {  // y clips, x wraps
      const int ii = ti + di;
      return ii < 0 || ii >= nby ? 0 : prev[ii * nbx + (tj + dj + nbx) % nbx];
    };
    int a = (bits(-1, 0) & kBottom) | (bits(1, 0) & kTop) |
                  (bits(0, -1) & kRight) | (bits(0, 1) & kLeft) |
                  (bits(-1, -1) & kBottomRight) | (bits(-1, 1) & kBottomLeft) |
                  (bits(1, -1) & kTopRight) | (bits(1, 1) & kTopLeft);
    if (wake) {
      a |= wake[blockIdx.x];
      wake[blockIdx.x] = 0;
    }
    awake = a;
    *out = 0;
    if (!a) cur[blockIdx.x] = 0;
  }
  __syncthreads();
  return awake;
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
// dirty row in any strip means the tile's local fixpoint.  Where `extra`
// is given (K12: a cell that reads a cell of another row of the tile),
// the cells mark rows there too, extra[w] for strip w, pulled with the
// marks.  Every row starts dirty but where `first_dirty` (uniform over
// the warp) says the caller knows a row satisfied.  Returns the rows
// where this thread's cell changed; *passes gets the passes taken.
template <int TY, int TX, typename Cell>
__device__ uint64_t relax(Cell cell, int* passes,
                          unsigned long long* extra = nullptr,
                          uint64_t first_dirty = ~0ull) {
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
  uint64_t dirty = all & first_dirty, touched = 0;
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
    if (lane == 0) {
      dirty |= atomicExch(&marks[w], 0ull);
      if (extra) dirty |= atomicExch(&extra[w], 0ull);
    }
    dirty = __shfl_sync(~0u, dirty, 0);
    if (!__syncthreads_or(dirty != 0) || p + 1 >= TY * TX) {
      *passes = p + 1;
      return touched;
    }
  }
}

// Step 4's bookkeeping: the edge bits of the rows `wrote` of this thread's
// column c, OR-ed over the block into *out; thread 0 then publishes them
// as cur[tile] (tile < 0: the block's own, blockIdx.x).
template <int TY, int TX>
__device__ void finish(uint64_t wrote, int c, int r0, int c0, int H, int W,
                       int* out, int* cur, int* stats, int slot,
                       int passes, int tile = -1) {
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
  cur[tile < 0 ? (int)blockIdx.x : tile] = *out & 0xff;
  atomicAdd(stats, 1);
  atomicMax(stats + 1, passes);
  if (*out) atomicOr(stats + kStatsHead + slot, 1);
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

// K10: whether a cell of band row rl with out bits `out` leaves its band
__device__ __forceinline__ bool crossing(int out, int rl, int band) {
  return (rl == 0 && (out & kNegOut)) || (rl == band - 1 && (out & kPosOut));
}

// shared memory of K7's visit (the halo'd A, the area and the cells'
// metadata) and of K8's (the halo'd vis and the pointers), in bytes
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

// K7's steps 2-4 on the tile at (r0, c0), in `smem` (area_smem bytes, 16
// aligned): load the halo'd A and the cells' metadata, relax to the local
// fixpoint, write back the cells that changed.  Returns the rows of this
// thread's column it wrote; *passes gets relax's passes.
template <int TY, int TX>
__device__ __forceinline__ uint64_t area_visit(
    unsigned char* smem, const int* __restrict__ packed,
    const float* __restrict__ area, float* A, int r0, int c0, int H, int W,
    int* passes) {
  constexpr int SW = TX + 2;
  volatile float* sA = reinterpret_cast<float*>(smem);
  float* sArea = reinterpret_cast<float*>(smem) + (TY + 2) * SW;
  uint16_t* sMeta = reinterpret_cast<uint16_t*>(sArea + TY * TX);
  const int t = threadIdx.x, c = c0 + t;
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
      passes);

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
  return wrote;
}

// K8's steps 2-4 on the tile at (r0, c0), in `smem` (vis_smem bytes, 16
// aligned): each cell of the halo'd tile points at a cell further down
// its path (at first its target; a sink, a halo cell or a cell beyond the
// grid at itself, and for K10b a crossing cell), and the pointers jump
// (next = next of next) until a cell reaches a 1 or points at an end.  In
// place: a pointer read at any time points further down the same path, and
// a cell only turns to 1 from a 1 on its path.  A pass that changes
// nothing leaves every cell either 1 or pointing at an end that holds 0:
// the tile's local fixpoint, in about log2 of its longest path passes.
// band == 0 is K8 (no crossing cells); band > 0 is K10b, whose crossing
// cells are ends and keep the seed they start from.  Returns the rows of
// this thread's column it wrote (each from 0 to 1); *passes the passes.
template <int TY, int TX>
__device__ __forceinline__ uint64_t vis_visit(
    unsigned char* smem, const int* __restrict__ packed, uint8_t* vis,
    int band, int r0, int c0, int H, int W, int* passes) {
  constexpr int SW = TX + 2, SN = (TY + 2) * SW;
  static_assert(TY <= 64, "a thread's rows are one 64-bit mask");
  static_assert(SN <= 32767, "a halo'd tile's cells are int16 indices");
  volatile uint8_t* sV = smem;
  volatile int16_t* sNext =
      reinterpret_cast<int16_t*>(smem + (SN + 15) / 16 * 16);
  const int t = threadIdx.x, c = c0 + t;
  load_halo<TY, TX>(sV, vis, r0, c0, H, W);
  point_down<TY, TX>(sNext, packed, r0, c, H, W, [&](int o, int r, int) {
    return band > 0 && crossing(o, r % band, band);
  });

  uint64_t touched = 0;
  int p = 0;
  for (bool changed = true; changed && p <= SN; ++p) {
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
  *passes = p;

  // a touched cell went from 0 to 1, and only this block writes it
  for (int li = 0; li < TY; ++li)
    if ((touched >> li) & 1) vis[(long)(r0 + li) * W + c] = 1;
  return touched;
}

// n rounds, the first of them the solve's round `first`: round t reads the
// tiles' edge bits flags[(t % 2) * nt ..] and writes flags[((t + 1) % 2) *
// nt ..] (K12's wake words follow at flags[(2 + t % 2) * nt ..], read and
// cleared in round t, set for round t + 1 at flags[(2 + (t + 1) % 2) *
// nt ..]).
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

// K7's, K8's, K10's and K12's tile: rows, columns = threads a block
// (PERF.md has the shapes raced)
constexpr int kTileRows = 16, kTileCols = 128;

}  // namespace

// K12: one Jacobi sweep of the lake-aware flow relaxation a launch, for
// Hopper (sm_90a).
//
// Replaces the sweep that demiurge_tpu/ops/flow.py flow_solve_stencil
// (:342-432, sweep :385) compiles into one device loop: XLA's fused
// 8-neighbour stencil with the lake connections' scatter in the same loop
// (no Pallas kernel behind it).  The port ran it as some 110 torch
// launches a sweep (kernels/lakeflow.py relax_sweep_twin, the plain twin).
//
// Per cell p = (y, x), from the previous sweep's A, vis and root (the
// "in" set) into the "out" set:
//   A[p]    = area[p] + A[nbr_i] for each incoming bit i (bits 0..7 of
//             packed) in NEIGHBORS_FLOW_ORDER, by __fadd_rn, left to
//             right; then + A[conn_src[p]] where bit 18 is set (the
//             twin's connection add comes after its taps)
//   vis[p]  = mouth (bit 16) | vis[nbr] of the outgoing bit (bits 8..15,
//             one-hot) | vis[conn_dst[p]] where bit 19 is set
//   root[p] = p at a sink (bit 17), else root[nbr] of the outgoing bit,
//             else -1  (only where root is carried: the pointers non-null)
// with nbr_i = core/topology.py shift(pole_wrap=False)'s neighbour: row
// clamp(y + dy_i), column (x + dx_i) mod W on an x-periodic grid and
// clamp(x + dx_i) on any other.  On a global grid the masks already drop
// rows beyond it (kernels/flow.py pack_masks), so the clamp only acts
// where the twin's shift clamps too.  The twin adds +0.0 where a bit is
// clear; skipping it is exact, since A is a sum of non-negative areas.
// There are no products, so nothing can contract into an fma: A is the
// twin's bit for bit.  conn_src and conn_dst (-1 where a cell has no
// connection) are read only where bits 18 and 19 say they hold one.
//
// Bound on this card: device-memory bytes.  What a sweep must move is
// packed, area (4 B each), A (4), vis (1) and root (4) read and A, vis
// and root written: 26 B a cell with root carried, 54.5 MB at
// 2048x1024, plus the connection lists (16 B a connection), against at
// most 9 adds a cell.  The neighbour reads hit the rows that the block
// and its row neighbours load anyway (L1/L2).  Design: the simplest one
// that is right -- one thread a cell, a block a 256-column piece of one
// row (x masked where 256 does not divide W), one launch a sweep, the
// sweeps of a call launched back to back on the caller's stream over two
// ping-pong sets.  A solve of N sweeps moves 26 N B a cell where each
// input read once and each output written once would do: the tiled
// redesign (many sweeps a launch in shared memory, as K7/K8) is queued
// in ROADMAP.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSinkBit = 1 << 17;
constexpr int kSrcBit = 1 << 18;
constexpr int kDstBit = 1 << 19;

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

// n sweeps, one launch each: sweep 0 reads set 0 (A0 vis0 root0) and
// writes set 1, then sets 1 and 2 alternate, so the last sweep writes set
// 1 for odd n and set 2 for even n.  Set 0 is not written.  root pointers
// null: root is not carried.  vis is one byte a cell (torch.bool).
// wrap_x: 1 on an x-periodic grid (columns wrap), 0 elsewhere (clamp).
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

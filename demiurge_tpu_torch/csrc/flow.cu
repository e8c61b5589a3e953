// The flow fixpoint — upstream area accumulation and mouth reachability —
// for Hopper (sm_90a); the band-local fixpoints of the two-level solve
// (K10) are at the end of the file.
//
// Replaces:
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
// periodic, out-of-range rows already masked off) one launch is one sweep,
// one thread per pixel, IN PLACE:
//     A[p]   = area[p] + sum_{i in scan order, inc_i} A[neighbour_i]
//     vis[p] = vis[p] | OR_i (out_i & vis[neighbour_i])   (vis starts at
//                                                          the mouths)
// The TPU kernel walks row bands in order with aliased in/out buffers,
// which gives Gauss-Seidel order across bands, and skips inactive bands.
// CUDA blocks run concurrently and in no order, so a thread may read a
// neighbour's value from before or after that neighbour's update in the
// same sweep.  That is safe here:
//   - every value read is one the cell held at some time in this sweep
//     (4-byte stores do not tear; loads go through L2, __ldcg);
//   - a cell whose upstream cells are all final computes its final value,
//     and a final cell rewrites the same bits; the graph is acyclic, so
//     after s sweeps every cell with a longest upstream path < s is final,
//     as with ping-pong buffers, and often sooner;
//   - a sweep writes a cell only when its bits change, and raises its own
//     flag when it writes.  A sweep with its flag down wrote nothing, so
//     every read in it saw the current state: each cell then satisfies its
//     equation, which proves the fixpoint.  The fixpoint is unique (each
//     A is the f32 sum, in scan order, of its area and its upstream
//     fixpoint values), so A equals the plain twin's Jacobi result bit for
//     bit from any warm start, and vis exactly.
// The host launches rounds of n sweeps, each with its own flag, and reads
// the n flags once per round (kernels/flow.py _solve_cuda); the sweeps of
// the round after the certifying one change nothing.
//
// Bound on this card: device-memory bytes.  The function must read the
// packed masks, the area and the start and write A (33.5 MB at
// 2048x1024), with one add per flow edge; the relaxation repeats sweeps of
// 16 bytes a pixel, which stay in the 50 MB L2 at that size.  Skipping
// converged tiles, as the TPU kernel skips bands, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 128;

__constant__ int kDx[8] = {1, 0, -1, 1, -1, 1, 0, -1};
__constant__ int kDy[8] = {1, 1, 1, 0, 0, -1, -1, -1};

__device__ __forceinline__ long neighbour(int r, int c, int k, int W) {
  int cc = c + kDx[k];
  cc = cc < 0 ? cc + W : (cc >= W ? cc - W : cc);
  return (long)(r + kDy[k]) * W + cc;
}

__global__ void flow_area_sweep_kernel(const int* __restrict__ packed,
                                       const float* __restrict__ area,
                                       float* A, int* flag, int H, int W) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  bool changed = false;
  if (c < W) {
    const long i = (long)r * W + c;
    const int p = __ldg(packed + i);
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
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

__global__ void flow_vis_sweep_kernel(const int* __restrict__ packed,
                                      uint8_t* vis, int* flag, int H,
                                      int W) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  bool changed = false;
  if (c < W) {
    const long i = (long)r * W + c;
    const int p = __ldg(packed + i);
    if (vis[i] == 0 && (p >> 8) & 0xff) {
      const volatile uint8_t* v = vis;
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
// K10: the band-local fixpoints of the two-level solve.
//
// Replaces demiurge_tpu/pallas_kernels/flow2.py flow_local_solve (:150,
// _local_kernel :78) and flow_local_vis (:331, _local_vis_kernel :291).
// Rows come in bands of `band`; the incoming bits that reach across a band
// edge are already cleared (kernels/flow2.py mask_local), so a band's A
// never reads another band.  A cell of a band's first row whose out bit
// points one row down (dy = -1), or of its last row pointing up (dy = +1),
// is a crossing cell: its exit id E is pinned to its own id (col on the
// first row, W + col on the last) and its vis to the seed.  Otherwise
//     A[p] = area[p] + sum_{i in scan order, inc_i} A[neighbour_i]
//     E[p] = E[target]   (target = the neighbour of p's one out bit; -1
//                         where p has no out bit)
//     vis[p] = seed[p] | OR_i (out_i & vis[neighbour_i])
// The TPU kernel runs one band per grid step, rolling whole (band, W)
// slabs in VMEM until a band-local flag says done.  Here bands need no
// block structure at all: one thread per pixel, in place, with K7's
// rounds of flagged sweeps and the same certificate (a sweep that wrote
// nothing); each fixpoint is unique, since D8 flow is acyclic both ways,
// so A, E and vis equal the plain twin's (kernels/flow2.py) bit for bit.
// Bound on this card: device-memory bytes, as K7 (20 bytes a pixel to
// read and write once; the sweeps stay in L2 at 2048x1024).  Skipping
// converged bands, as the TPU kernel's per-band loop does, is later work.

constexpr int kNegOut = (1 << 5) | (1 << 6) | (1 << 7);  // out bits, dy = -1
constexpr int kPosOut = (1 << 0) | (1 << 1) | (1 << 2);  // out bits, dy = +1

__device__ __forceinline__ bool crossing(int out, int rl, int band) {
  return (rl == 0 && (out & kNegOut)) || (rl == band - 1 && (out & kPosOut));
}

__global__ void flow_local_sweep_kernel(const int* __restrict__ packed,
                                        const float* __restrict__ area,
                                        float* A, int* E, int* flag, int H,
                                        int W, int band) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  bool changed = false;
  if (c < W) {
    const long i = (long)r * W + c;
    const int p = __ldg(packed + i);
    float acc = __ldg(area + i);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if ((p >> k) & 1)
        acc = __fadd_rn(acc, __ldcg(A + neighbour(r, c, k, W)));
    if (__float_as_int(acc) != __float_as_int(__ldcg(A + i))) {
      __stcg(A + i, acc);
      changed = true;
    }
    if (E != nullptr) {
      const int out = (p >> 8) & 0xff;
      const int rl = r % band;
      int e = -1;
      if (crossing(out, rl, band))
        e = rl == 0 ? c : W + c;
      else if (out)
        e = __ldcg(E + neighbour(r, c, __ffs(out) - 1, W));
      if (e != __ldcg(E + i)) {
        __stcg(E + i, e);
        changed = true;
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

__global__ void flow_local_vis_sweep_kernel(const int* __restrict__ packed,
                                            uint8_t* vis, int* flag, int H,
                                            int W, int band) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  bool changed = false;
  if (c < W) {
    const long i = (long)r * W + c;
    const int p = __ldg(packed + i);
    const int out = (p >> 8) & 0xff;
    if (vis[i] == 0 && out && !crossing(out, r % band, band)) {
      const volatile uint8_t* v = vis;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (((out >> k) & 1) && v[neighbour(r, c, k, W)]) {
          vis[i] = 1;
          changed = true;
        }
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

extern "C" {

// n in-place sweeps of the A relaxation; sweep j sets flags[j] = 1 if it
// changed a cell (the caller zeroes flags[0..n)).
int demiurge_flow_area_sweeps(const int* packed, const float* area,
                              float* A, int* flags, int H, int W, int n,
                              void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  for (int j = 0; j < n; ++j) {
    flow_area_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        packed, area, A, flags + j, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// n in-place sweeps of the vis relaxation (vis: one byte a pixel, 0 or 1).
int demiurge_flow_vis_sweeps(const int* packed, uint8_t* vis, int* flags,
                             int H, int W, int n, void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  for (int j = 0; j < n; ++j) {
    flow_vis_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        packed, vis, flags + j, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// n in-place sweeps of the band-local A relaxation, and of the exit ids
// when E is not null (K10a).
int demiurge_flow_local_sweeps(const int* packed, const float* area,
                               float* A, int* E, int* flags, int H, int W,
                               int band, int n, void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  for (int j = 0; j < n; ++j) {
    flow_local_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        packed, area, A, E, flags + j, H, W, band);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// n in-place sweeps of the band-local vis relaxation (K10b); vis starts at
// max(mouth, seed), one byte a pixel.
int demiurge_flow_local_vis_sweeps(const int* packed, uint8_t* vis,
                                   int* flags, int H, int W, int band, int n,
                                   void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  for (int j = 0; j < n; ++j) {
    flow_local_vis_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        packed, vis, flags + j, H, W, band);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// Iterations of the separable spherical blur, for Hopper (sm_90a).
//
// Replaces demiurge_tpu/pallas_kernels/blur.py: blur_pallas (:135,
// _kernel :80, _tables :58) — every sigma_list iteration of the flow
// pre-blur.
//
// Two launches per iteration, one thread per pixel, out of place:
//   - vertical: out = W0*f + sum_t w_t * (v0_t*f[rk_t] + v1_t*f[rk_t + 1])
//     with the row r + k resolved as core.topology.shift does: beyond a
//     pole (|k| < H) the mirrored row on the other side at column
//     c + pole_shift, otherwise clamped;
//   - horizontal: out = W0*f + sum_t w_t * (h0*f[r, c+k] + h1*f[r, c+k+1])
//     with a per-row column shift k_{t,r} (mod W) and lerp pair, periodic.
// The six taps t run in the pass's order (offset ascending, + before -).
// The TPU kernel collapses the vertical pass to a*f + b*(up + dn) (valid
// for sub-pixel offsets) and runs the horizontal taps as barrel rolls on
// VMEM bands with reflect-padded pole halos; here each thread reads its
// taps directly, which is the reference's pass at any radius and grid
// size.  The sums follow the plain twin (ops.blur.blur13_pass) term by
// term with explicitly rounded operations, so the two agree bit for bit.
//
// Bound on this card: device-memory bytes.  A pass reads one plane and
// writes one (16.8 MB at 2048x1024, L2-resident between passes) against
// about 30 flops a pixel; the tables are a few KB per row set.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 128;
constexpr int kTaps = 6;

__device__ __forceinline__ float fetch_row(const float* __restrict__ f,
                                           int r, int k, int c, int H,
                                           int W, int wrap_s, int wrap_n,
                                           int pole_shift) {
  int rr = r + k;
  int cc = c;
  if (rr >= H) {
    if (wrap_n && k < H) {
      rr = 2 * H - 1 - rr;
      cc = (c + pole_shift) % W;
    } else {
      rr = H - 1;
    }
  } else if (rr < 0) {
    if (wrap_s && -k < H) {
      rr = -rr - 1;
      cc = (c + pole_shift) % W;
    } else {
      rr = 0;
    }
  }
  return __ldg(f + (long)rr * W + cc);
}

__global__ void blur_vertical_kernel(const float* __restrict__ in,
                                     const int* __restrict__ vk,
                                     const float* __restrict__ vw,
                                     const float* __restrict__ weights,
                                     float* __restrict__ out, int H, int W,
                                     int wrap_s, int wrap_n, int pole_shift) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;
  const long i = (long)r * W + c;
  float acc = __fmul_rn(__ldg(in + i), __ldg(weights));
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int k = __ldg(vk + t);
    const float v0 = __ldg(vw + 2 * t), v1 = __ldg(vw + 2 * t + 1);
    float tap = __fmul_rn(
        fetch_row(in, r, k, c, H, W, wrap_s, wrap_n, pole_shift), v0);
    if (v1 != 0.0f)
      tap = __fadd_rn(tap, __fmul_rn(fetch_row(in, r, k + 1, c, H, W,
                                               wrap_s, wrap_n, pole_shift),
                                     v1));
    acc = __fadd_rn(acc, __fmul_rn(tap, __ldg(weights + 1 + t / 2)));
  }
  out[i] = acc;
}

__global__ void blur_horizontal_kernel(const float* __restrict__ in,
                                       const int* __restrict__ hk,
                                       const float* __restrict__ hw,
                                       const float* __restrict__ weights,
                                       float* __restrict__ out, int H,
                                       int W) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;
  const float* __restrict__ row = in + (long)r * W;
  float acc = __fmul_rn(__ldg(row + c), __ldg(weights));
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    int c0 = c + __ldg(hk + (long)t * H + r);
    if (c0 >= W) c0 -= W;
    int c1 = c0 + 1;
    if (c1 == W) c1 = 0;
    const float h0 = __ldg(hw + (long)(2 * t) * H + r);
    const float h1 = __ldg(hw + (long)(2 * t + 1) * H + r);
    const float tap = __fadd_rn(__fmul_rn(__ldg(row + c0), h0),
                                __fmul_rn(__ldg(row + c1), h1));
    acc = __fadd_rn(acc, __fmul_rn(tap, __ldg(weights + 1 + t / 2)));
  }
  out[(long)r * W + c] = acc;
}

}  // namespace

extern "C" {

// n_iter iterations from `field`.  vk (n, 6) int, vw (n, 6, 2) float,
// hk (n, 6, H) int (column shifts mod W), hw (n, 6, 2, H) float, weights
// (4,) float.  Iteration i writes its vertical pass to ping and its
// horizontal pass to pong; the result is in pong.
int demiurge_blur(const float* field, const int* vk, const float* vw,
                  const int* hk, const float* hw, const float* weights,
                  float* ping, float* pong, int H, int W, int wrap_s,
                  int wrap_n, int pole_shift, int n_iter, void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  cudaStream_t s = (cudaStream_t)stream;
  for (int it = 0; it < n_iter; ++it) {
    blur_vertical_kernel<<<grid, block, 0, s>>>(
        it == 0 ? field : pong, vk + it * kTaps, vw + it * kTaps * 2,
        weights, ping, H, W, wrap_s, wrap_n, pole_shift);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    blur_horizontal_kernel<<<grid, block, 0, s>>>(
        ping, hk + (long)it * kTaps * H, hw + (long)it * kTaps * 2 * H,
        weights, pong, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

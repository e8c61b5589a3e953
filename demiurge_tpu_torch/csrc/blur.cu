// Iterations of the separable spherical blur, for Hopper (sm_90a).
//
// Replaces demiurge_tpu/pallas_kernels/blur.py: blur_pallas (:135,
// _kernel :80, _tables :58) — every sigma_list iteration of the flow
// pre-blur.
//
// An iteration is two passes, out of place:
//   - vertical: out = W0*f + sum_t w_t * (v0_t*f[rk_t] + v1_t*f[rk_t + 1])
//     with the row r + k resolved as core.topology.shift does: beyond a
//     pole (|k| < H) the mirrored row on the other side at column
//     c + pole_shift, otherwise clamped;
//   - horizontal: out = W0*f + sum_t w_t * (h0*f[r, c+k] + h1*f[r, c+k+1])
//     with a per-row column shift k_{t,r} (mod W) and lerp pair, periodic.
// The six taps t run in the pass's order (offset ascending, + before -).
// The sums follow the plain twin (ops.blur.blur13_pass) term by term with
// explicitly rounded operations, so the two agree bit for bit.
//
// Bound on this card: operations.  The flow pre-blur (radius 0.5, 5
// iterations) reads and writes one plane (16.8 MB at 2048x1024) against
// 62 flops a pixel an iteration.  One launch a pass (the port's first
// kernel) wrote an intermediate plane a pass: 23.5 us a launch, 10
// launches.
//
// Design: temporal blocking on full-width row bands (bands.cuh), as the
// TPU kernel keeps its field in VMEM across the iterations of a call.  One
// launch runs a group of iterations whose vertical reaches R_i (rows, 1
// each at radius 0.5) sum to its halo (kernels/bands.py groups them: one
// launch at radius 0.5).  A cluster of blocks loads a band of th rows plus
// the halo, whole, into shared memory once; each iteration's vertical pass
// goes to the second buffer (the band's right rows shrink by R_i) and its
// horizontal pass back, across the cluster for the polar rows, whose taps
// reach hundreds of columns; then the block writes its th rows.  The TPU
// kernel collapses the vertical pass to a*f + b*(up + dn) and rolls the
// horizontal taps through VMEM bands with reflect-padded pole halos; here
// the halo rows past a pole are the physical rows, read at their own
// taps, which serves any radius and grid.  An iteration whose reach
// alone outgrows a band (radii far beyond the model's) runs as the two
// one-pass kernels below, a launch each.
// tests/test_torch_blur_tiles.py runs this schedule in numpy against the
// twin.

#include "bands.cuh"

namespace {

constexpr int kBlockX = 128;
constexpr int kTaps = 6;
// the band kernel: cells a lane takes at once, threads a block, the row
// table's ints a row, and floats past the last plane (an item's lanes past
// the block's columns read, and never store, up to 32 * kCells - 1 on)
constexpr int kCells = 4;
constexpr int kBandThreads = 512;
constexpr int kRowInts = 4;
constexpr int kSlack = 32 * kCells;

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

__host__ __device__ constexpr size_t band_floats(int eh, int seg) {
  return (size_t)eh * (kRowInts + 2 * (seg + 2 * bands::kMargin)) + kSlack;
}

__global__ void __launch_bounds__(kBandThreads, 1) blur_band_kernel(
    const float* __restrict__ field, const int* __restrict__ vk,
    const float* __restrict__ vw, const int* __restrict__ hk,
    const float* __restrict__ hw, const float* __restrict__ weights,
    float* __restrict__ out, int H, int W, int wrap_s, int wrap_n,
    int pole_shift, int n_iter, int halo, int seg, int th) {
  namespace cg = bands::cg;
  constexpr int M = bands::kMargin;
  constexpr int kWarps = kBandThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int eh = th + 2 * halo;
  const int r0 = bands::band_of(blockIdx.y, gridDim.y) * th;
  const int c0 = (int)cluster.block_rank() * seg;
  const int ncols = min(seg, W - c0);
  const int stride = seg + 2 * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = W % 4 == 0 && seg % 4 == 0;
  // band_smem: the row table (physical row, orientation), two buffers with
  // margins
  int* const rows = (int*)bands::band_smem;
  const bands::Plane a(kRowInts * eh, seg, c0, ncols);
  const bands::Plane b(kRowInts * eh + eh * stride, seg, c0, ncols);

  for (int j = tid; j < eh; j += kBandThreads) {
    int q, dir;
    bands::unfold(r0 - halo + j, H, q, dir);
    rows[kRowInts * j] = q;
    rows[kRowInts * j + 1] = dir;
  }
  __syncthreads();
  for (int j = warp; j < eh; j += kWarps)
    bands::load_row(&a.near(j, 0), field + (long)rows[kRowInts * j] * W, c0,
                    0, ncols, W, vec, lane);
  bands::wait_copies();
  cluster.sync();

  float wt[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) wt[t] = __ldg(weights + t);
  // an item is kCells cells of one row, 32 columns apart, a lane: their
  // loads all go out before the first sum
  const int groups = (ncols + 32 * kCells - 1) / (32 * kCells);
  const unsigned inv_groups = bands::reciprocal(groups);
  int lo = 0;
  for (int it = 0; it < n_iter; ++it) {
    int vkk[kTaps];
    float v0[kTaps], v1[kTaps];
    int kmin = 0, kmax = 0;  // the row offsets the taps read
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      vkk[t] = __ldg(vk + it * kTaps + t);
      v0[t] = __ldg(vw + (it * kTaps + t) * 2);
      v1[t] = __ldg(vw + (it * kTaps + t) * 2 + 1);
      kmin = min(kmin, vkk[t]);
      kmax = max(kmax, v1[t] != 0.0f ? vkk[t] + 1 : vkk[t]);
    }
    lo += max(kmax, -kmin);
    const int* const ihk = hk + (long)it * kTaps * H;
    const float* const ihw = hw + (long)it * kTaps * 2 * H;
    const int items = (eh - 2 * lo) * groups;

    // vertical: buf0 -> buf1, the rows still right; a row whose taps
    // cross no pole reads its own columns only
    for (int i = warp; i < items; i += kWarps) {
      const int jr = bands::divide(i, inv_groups);
      const int j = lo + jr;
      const int l0 = (i - jr * groups) * 32 * kCells + lane;
      const int q = rows[kRowInts * j], dir = rows[kRowInts * j + 1];
      float v[kCells][2 * kTaps], f[kCells];
      if (q + kmin >= 0 && q + kmax < H) {
#pragma unroll
        for (int u = 0; u < kCells; ++u)
#pragma unroll
          for (int t = 0; t < kTaps; ++t) {
            v[u][2 * t] = a.near(j + dir * vkk[t], l0 + 32 * u);
            // a tap without a second row reads its first one twice
            v[u][2 * t + 1] = a.near(
                j + dir * (v1[t] != 0.0f ? vkk[t] + 1 : vkk[t]),
                l0 + 32 * u);
          }
      } else {
        int js[2 * kTaps], off[2 * kTaps];
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          int2 src = bands::row_source(q, dir, vkk[t], H, wrap_s, wrap_n,
                                       pole_shift);
          js[2 * t] = j + src.x;
          off[2 * t] = src.y;
          if (v1[t] != 0.0f)
            src = bands::row_source(q, dir, vkk[t] + 1, H, wrap_s, wrap_n,
                                    pole_shift);
          js[2 * t + 1] = j + src.x;
          off[2 * t + 1] = src.y;
        }
#pragma unroll
        for (int u = 0; u < kCells; ++u) {
          const int c = c0 + min(l0 + 32 * u, ncols - 1);
#pragma unroll
          for (int t = 0; t < 2 * kTaps; ++t)
            v[u][t] = a.far(js[t], bands::wrap(c + off[t], W));
        }
      }
#pragma unroll
      for (int u = 0; u < kCells; ++u) f[u] = a.near(j, l0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        float acc = __fmul_rn(f[u], wt[0]);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          float tap = __fmul_rn(v[u][2 * t], v0[t]);
          if (v1[t] != 0.0f)
            tap = __fadd_rn(tap, __fmul_rn(v[u][2 * t + 1], v1[t]));
          acc = __fadd_rn(acc, __fmul_rn(tap, wt[1 + t / 2]));
        }
        if (l0 + 32 * u < ncols) b.push(j, l0 + 32 * u, acc, W);
      }
    }
    cluster.sync();

    // horizontal: buf1 -> buf0, the same rows; a row whose taps stay
    // within the margin reads this block's columns only
    for (int i = warp; i < items; i += kWarps) {
      const int jr = bands::divide(i, inv_groups);
      const int j = lo + jr;
      const int l0 = (i - jr * groups) * 32 * kCells + lane;
      const int q = rows[kRowInts * j];
      int hs[kTaps];
      float h[2 * kTaps];
      bool near = true;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        hs[t] = bands::signed_shift(__ldg(ihk + (long)t * H + q), W);
        h[2 * t] = __ldg(ihw + (long)(2 * t) * H + q);
        h[2 * t + 1] = __ldg(ihw + (long)(2 * t + 1) * H + q);
        near = near && -M <= hs[t] && hs[t] < M;
      }
      float v[kCells][2 * kTaps], f[kCells];
      if (near) {
#pragma unroll
        for (int u = 0; u < kCells; ++u)
#pragma unroll
          for (int t = 0; t < kTaps; ++t) {
            v[u][2 * t] = b.near(j, l0 + 32 * u + hs[t]);
            v[u][2 * t + 1] = b.near(j, l0 + 32 * u + hs[t] + 1);
          }
      } else {
#pragma unroll
        for (int u = 0; u < kCells; ++u) {
          const int c = c0 + min(l0 + 32 * u, ncols - 1);
#pragma unroll
          for (int t = 0; t < kTaps; ++t) {
            const int x0 = bands::wrap(c + hs[t], W);
            v[u][2 * t] = b.far(j, x0);
            v[u][2 * t + 1] = b.far(j, x0 + 1 == W ? 0 : x0 + 1);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCells; ++u) f[u] = b.near(j, l0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        float acc = __fmul_rn(f[u], wt[0]);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float tap =
              __fadd_rn(__fmul_rn(v[u][2 * t], h[2 * t]),
                        __fmul_rn(v[u][2 * t + 1], h[2 * t + 1]));
          acc = __fadd_rn(acc, __fmul_rn(tap, wt[1 + t / 2]));
        }
        if (l0 + 32 * u < ncols) a.near(j, l0 + 32 * u) = acc;
      }
    }
    cluster.sync();
  }

  for (int j = halo + warp; j < halo + th; j += kWarps) {
    const int r = r0 + j - halo;
    if (r >= H) break;
    bands::store_row(out + (long)r * W + c0, &a.near(j, 0), ncols, vec,
                     lane);
  }
}

}  // namespace

extern "C" {

// n_iter iterations from `field`, a vertical and a horizontal launch
// each (the iterations a band cannot hold).  vk (n, 6) int, vw (n, 6, 2)
// float, hk (n, 6, H) int (column shifts mod W), hw (n, 6, 2, H) float,
// weights (4,) float.  Iteration i writes its vertical pass to ping and its
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

// n_iter iterations from `field` into out in one launch of bands of th
// rows, `cluster` blocks of `seg` columns each; halo is the sum of the
// iterations' vertical reaches (kernels/bands.py plans them).  Tables as
// for demiurge_blur, from the group's first iteration.  A geometry that
// does not cover the grid, or shared memory beyond a block's, is refused
// with cudaErrorInvalidValue.
int demiurge_blur_band(const float* field, const int* vk, const float* vw,
                       const int* hk, const float* hw, const float* weights,
                       float* out, int H, int W, int wrap_s, int wrap_n,
                       int pole_shift, int n_iter, int halo, int cluster,
                       int seg, int th, void* stream) {
  if (!bands::accepted(W, H, cluster, seg, th, halo) || n_iter < 1)
    return (int)cudaErrorInvalidValue;
  const int eh = th + 2 * halo;
  const size_t smem = sizeof(float) * band_floats(eh, seg);
  const int nbands = (H + th - 1) / th;
  return (int)bands::launch(blur_band_kernel, kBandThreads, cluster, nbands,
                            smem,
                            (cudaStream_t)stream, field, vk, vw, hk, hw,
                            weights, out, H, W, wrap_s, wrap_n, pole_shift,
                            n_iter, halo, seg, th);
}

// Clusters of `cluster` blocks with `smem` bytes each that the card holds
// at once.
int demiurge_blur_band_clusters(int cluster, int smem) {
  return bands::max_clusters(blur_band_kernel, kBandThreads, cluster,
                             (size_t)smem);
}

}  // extern "C"

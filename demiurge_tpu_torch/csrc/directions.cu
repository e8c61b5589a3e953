// The D8 direction pass of the flow routing, for Hopper (sm_90a).
//
// Replaces demiurge_tpu/pallas_kernels/directions.py:
// flow_directions_pallas (:152, _kernel :59).
//
// One thread per pixel reads the 3x3 neighbourhood of the blurred height
// and of the selection on the "coordsMod" grid (x periodic, y clamped at
// the edge rows) and computes, in the plain twin's order
// (kernels/directions.py flow_directions_plain):
//   gx = (-(c + 2f + i) + (a + 2d + g)) / dx8[r]
//   gy = ((g + 2h + i) - (a + 2b + c)) / dy8
//   aspect = pi - atan2(gy, -gx); lower/upper = floor/ceil(aspect/2pi*8)
//   /8*2pi; asp = q < |aspect - lower|/pi*4 ? upper : lower
//   dirx = rint(cos(asp)), diry = -rint(sin(asp)), code = 5 + dirx + 3 diry
// then the aspect-neighbour check and the steepest-descent fallback in the
// reference's scan order.  The TPU kernel stands a polynomial in for atan2
// (Mosaic has none); this one calls atan2f, as the plain twin does.  The
// tie-break noise q and the metric dx8 = 8 dx come in as tables, built
// once per grid by the twin's own torch ops: the hash fract(px*py*(px+py))
// with px, py up to 50 turns any contraction or reassociation into another
// q, so it is not recomputed here.  Arithmetic is explicitly rounded (no
// FMA contraction).
//
// Bound on this card: device-memory bytes — two float planes and the q
// table in, one int plane out (33.5 MB at 2048x1024) against some 80
// flops and one atan2f, sinf and cosf a pixel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 128;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// scan order of the steepest-descent fallback (FlowFilter.cpp:181-236)
__constant__ int kScanDx[8] = {1, 0, -1, 1, -1, 1, 0, -1};
__constant__ int kScanDy[8] = {1, 1, 1, 0, 0, -1, -1, -1};

__global__ void flow_directions_kernel(const float* __restrict__ hb,
                                       const float* __restrict__ sel,
                                       const float* __restrict__ q,
                                       const float* __restrict__ dx8,
                                       int* __restrict__ code_out, int H,
                                       int W, float dy8) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;

  // 3x3 neighbourhood, n[dy + 1][dx + 1]: x periodic, y clamped
  float nh[3][3], ns[3][3];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    int rr = r + dy;
    rr = rr < 0 ? 0 : (rr > H - 1 ? H - 1 : rr);
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      int cc = c + dx;
      cc = cc < 0 ? cc + W : (cc >= W ? cc - W : cc);
      const long j = (long)rr * W + cc;
      nh[dy + 1][dx + 1] = __ldg(hb + j);
      ns[dy + 1][dx + 1] = __ldg(sel + j);
    }
  }
  const float a = nh[1][1];
  const long i = (long)r * W + c;
  if (!(a > 0.0f && ns[1][1] != 0.0f)) {
    code_out[i] = 0;
    return;
  }

  // Sobel, the reference's names: a b c (south row), d e f, g h i (north)
  const float ta = nh[0][0], tb = nh[0][1], tc = nh[0][2];
  const float td = nh[1][0], tf = nh[1][2];
  const float tg = nh[2][0], th = nh[2][1], ti = nh[2][2];
  const float east = __fadd_rn(__fadd_rn(tc, __fmul_rn(2.0f, tf)), ti);
  const float west = __fadd_rn(__fadd_rn(ta, __fmul_rn(2.0f, td)), tg);
  const float gx = __fdiv_rn(__fadd_rn(-east, west), __ldg(dx8 + r));
  const float north = __fadd_rn(__fadd_rn(tg, __fmul_rn(2.0f, th)), ti);
  const float south = __fadd_rn(__fadd_rn(ta, __fmul_rn(2.0f, tb)), tc);
  const float gy = __fdiv_rn(__fsub_rn(north, south), dy8);

  const float aspect = __fsub_rn(kPi, atan2f(gy, -gx));
  const float oct = __fmul_rn(__fdiv_rn(aspect, kTwoPi), 8.0f);
  const float lower = __fmul_rn(__fdiv_rn(floorf(oct), 8.0f), kTwoPi);
  const float upper = __fmul_rn(__fdiv_rn(ceilf(oct), 8.0f), kTwoPi);
  const float prob =
      __fmul_rn(__fdiv_rn(fabsf(__fsub_rn(aspect, lower)), kPi), 4.0f);
  const float asp = __ldg(q + i) < prob ? upper : lower;
  const int dirx = (int)rintf(cosf(asp));
  const int diry = -(int)rintf(sinf(asp));
  int code = 5 + dirx + 3 * diry;

  // the aspect's neighbour
  float a2 = INFINITY, s2 = 1.0f;
  if (dirx >= -1 && dirx <= 1 && diry >= -1 && diry <= 1 &&
      (dirx != 0 || diry != 0)) {
    a2 = nh[diry + 1][dirx + 1];
    s2 = ns[diry + 1][dirx + 1];
  }
  if (a2 <= 0.0f || s2 == 0.0f) code = 5;
  if (!(a2 < a)) {
    // steepest-descent fallback (FlowFilter.cpp:178-242)
    int best_code = 5;
    float best_a = a, best_s = 1.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = kScanDx[k], dy = kScanDy[k];
      const float v = nh[dy + 1][dx + 1];
      if (v < best_a) {
        best_code = 5 + dx + 3 * dy;
        best_s = ns[dy + 1][dx + 1];
        best_a = v;
      }
    }
    code = (best_a <= 0.0f || best_s == 0.0f) ? 5 : best_code;
  }
  code_out[i] = code;
}

}  // namespace

extern "C" {

// codes (H, W) int from the blurred height and the selection; q (H, W)
// tie-break noise, dx8 (H,) = 8 dx per row of the coordsMod grid.
int demiurge_flow_directions(const float* hb, const float* sel,
                             const float* q, const float* dx8, int* code,
                             int H, int W, float dy8, void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  flow_directions_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      hb, sel, q, dx8, code, H, W, dy8);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The D8 direction pass of the flow routing, and the packed flow masks
// built from it, for Hopper (sm_90a).
//
// Replaces demiurge_tpu/pallas_kernels/directions.py:
// flow_directions_pallas (:152, _kernel :59).
//
// Per pixel, on the 3x3 neighbourhood of the blurred height and of the
// selection on the "coordsMod" grid (x periodic, y clamped at the edge
// rows), in the plain twin's order (kernels/directions.py
// flow_directions_plain):
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
// A block owns a kTileY x kTileX tile.  It loads hb and sel of the tile
// and a 2-cell halo (rows clamped, columns mod W) into shared memory once.
// Two forms (directions_kernel<kPacked>):
//   - codes (kPacked = false): the tile's codes;
//   - packed (kPacked = true): the codes of the tile and of a 1-cell ring
//     around it into shared memory, then, per tile cell, its code and the
//     int32 field K7/K8 read (kernels/flow.py pack_masks):
//       bits 0..7  incoming: the neighbour at scan offset k (x periodic, no
//                  pole wrap: a row beyond the grid drops; columns beyond
//                  the range drop where the grid is not a full globe)
//                  points here, its code 5 - dx - 3 dy;
//       bits 8..15 outgoing: my code is 5 + dx + 3 dy and row r + dy
//                  exists;
//       bit 16     mouth: I am interesting and a pole-wrapped neighbour is
//                  not.  A code is 0 exactly where a pixel is not
//                  interesting, !(hb > 0 && sel != 0) (every other path
//                  yields 1-9), so this is ops/flow.py incoming_mask's
//                  ncode == 0 test with no arithmetic that can round.  A
//                  neighbour beyond a pole is the edge row turned by half
//                  the world (topology.shift): the pole rows read it from
//                  device memory.
//   That is directions, incoming_mask and pack_masks (some 60 torch
//   launches) in one launch.
//
// Bound on this card: device-memory bytes — hb, sel and q in, the codes
// and the packed field out (42 MB at 2048x1024) against some 80 flops
// and one atan2f, sinf and cosf a pixel (the ring's 14% more).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileY = 16;
constexpr int kTileX = 128;
constexpr int kThreads = 256;
constexpr int kHaloY = kTileY + 4, kHaloX = kTileX + 4;  // 2-cell halo
constexpr int kRingY = kTileY + 2, kRingX = kTileX + 2;  // 1-cell ring
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// scan order of the steepest-descent fallback (FlowFilter.cpp:181-236),
// also the bit order of the packed field: (1,1) (0,1) (-1,1) (1,0) (-1,0)
// (1,-1) (0,-1) (-1,-1).  Functions, not a table, so that an unrolled
// loop's offsets are constants and the 3x3 arrays stay in registers.
__device__ __forceinline__ constexpr int scan_dx(int k) {
  return k < 3 ? 1 - k : (k == 3 ? 1 : (k == 4 ? -1 : 6 - k));
}
__device__ __forceinline__ constexpr int scan_dy(int k) {
  return k < 3 ? 1 : (k < 5 ? 0 : -1);
}

__device__ __forceinline__ int wrap_col(int c, int W) {
  c %= W;
  return c < 0 ? c + W : c;
}

__device__ __forceinline__ int clamp_row(int r, int H) {
  return r < 0 ? 0 : (r > H - 1 ? H - 1 : r);
}

// The code of the cell at halo position (j, i), its 3x3 neighbourhood in
// the halo (n[dy + 1][dx + 1] = halo[j + dy][i + dx]).
__device__ int d8_code(const float (*sh)[kHaloX], const float (*ss)[kHaloX],
                       int j, int i, float q, float dx8, float dy8) {
  float nh[3][3], ns[3][3];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      nh[dy + 1][dx + 1] = sh[j + dy][i + dx];
      ns[dy + 1][dx + 1] = ss[j + dy][i + dx];
    }
  }
  const float a = nh[1][1];
  if (!(a > 0.0f && ns[1][1] != 0.0f)) return 0;

  // Sobel, the reference's names: a b c (south row), d e f, g h i (north)
  const float ta = nh[0][0], tb = nh[0][1], tc = nh[0][2];
  const float td = nh[1][0], tf = nh[1][2];
  const float tg = nh[2][0], th = nh[2][1], ti = nh[2][2];
  const float east = __fadd_rn(__fadd_rn(tc, __fmul_rn(2.0f, tf)), ti);
  const float west = __fadd_rn(__fadd_rn(ta, __fmul_rn(2.0f, td)), tg);
  const float gx = __fdiv_rn(__fadd_rn(-east, west), dx8);
  const float north = __fadd_rn(__fadd_rn(tg, __fmul_rn(2.0f, th)), ti);
  const float south = __fadd_rn(__fadd_rn(ta, __fmul_rn(2.0f, tb)), tc);
  const float gy = __fdiv_rn(__fsub_rn(north, south), dy8);

  const float aspect = __fsub_rn(kPi, atan2f(gy, -gx));
  const float oct = __fmul_rn(__fdiv_rn(aspect, kTwoPi), 8.0f);
  const float lower = __fmul_rn(__fdiv_rn(floorf(oct), 8.0f), kTwoPi);
  const float upper = __fmul_rn(__fdiv_rn(ceilf(oct), 8.0f), kTwoPi);
  const float prob =
      __fmul_rn(__fdiv_rn(fabsf(__fsub_rn(aspect, lower)), kPi), 4.0f);
  const float asp = q < prob ? upper : lower;
  const int dirx = (int)rintf(cosf(asp));
  const int diry = -(int)rintf(sinf(asp));
  int code = 5 + dirx + 3 * diry;

  // the aspect's neighbour, read from the halo: indexing nh/ns by the
  // runtime (dirx, diry) would put them in local memory
  float a2 = INFINITY, s2 = 1.0f;
  if (dirx >= -1 && dirx <= 1 && diry >= -1 && diry <= 1 &&
      (dirx != 0 || diry != 0)) {
    a2 = sh[j + diry][i + dirx];
    s2 = ss[j + diry][i + dirx];
  }
  if (a2 <= 0.0f || s2 == 0.0f) code = 5;
  if (!(a2 < a)) {
    // steepest-descent fallback (FlowFilter.cpp:178-242)
    int best_code = 5;
    float best_a = a, best_s = 1.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = scan_dx(k), dy = scan_dy(k);
      const float v = nh[dy + 1][dx + 1];
      if (v < best_a) {
        best_code = 5 + dx + 3 * dy;
        best_s = ns[dy + 1][dx + 1];
        best_a = v;
      }
    }
    code = (best_a <= 0.0f || best_s == 0.0f) ? 5 : best_code;
  }
  return code;
}

__device__ __forceinline__ bool interesting(float h, float s) {
  return h > 0.0f && s != 0.0f;
}

// The packed form's second part, after the halo is loaded: the codes of
// the tile and its ring into shared memory, then each tile cell's code and
// packed masks.  turn_s / turn_n: the column turn of a neighbour beyond
// the south / north pole, in columns (0 where that edge clamps); wrap: the
// grid is a full globe, so incoming columns wrap over the dateline.
__device__ void packed_tile(const float (*sh)[kHaloX],
                            const float (*ss)[kHaloX],
                            const float* __restrict__ hb,
                            const float* __restrict__ sel,
                            const float* __restrict__ q,
                            const float* __restrict__ dx8,
                            int* __restrict__ code_out,
                            int* __restrict__ packed_out, int r0, int c0,
                            int H, int W, float dy8, int turn_s, int turn_n,
                            int wrap) {
  __shared__ int sc[kRingY][kRingX];
  const int tid = threadIdx.x;
  // rows beyond the grid are coded on the clamped rows and never read
  for (int k = tid; k < kRingY * kRingX; k += kThreads) {
    const int j = k / kRingX, i = k % kRingX;
    const int rr = clamp_row(r0 - 1 + j, H);
    const long g = (long)rr * W + wrap_col(c0 - 1 + i, W);
    sc[j][i] = d8_code(sh, ss, j + 1, i + 1, __ldg(q + g), __ldg(dx8 + rr),
                       dy8);
  }
  __syncthreads();

  for (int k = tid; k < kTileY * kTileX; k += kThreads) {
    const int j = k / kTileX, i = k % kTileX;
    const int r = r0 + j, c = c0 + i;
    if (r >= H || c >= W) continue;
    const int code = sc[j + 1][i + 1];
    int bits = 0;
    bool open = false;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int dx = scan_dx(n), dy = scan_dy(n);
      const int rn = r + dy;
      const bool row_ok = rn >= 0 && rn < H;
      const bool col_ok = wrap || (dx > 0 ? c < W - dx : c >= -dx);
      if (row_ok && col_ok && sc[j + 1 + dy][i + 1 + dx] == 5 - dx - 3 * dy)
        bits |= 1 << n;
      if (row_ok && code == 5 + dx + 3 * dy) bits |= 1 << (8 + n);
      float nh, ns;
      if (row_ok) {
        nh = sh[j + 2 + dy][i + 2 + dx];
        ns = ss[j + 2 + dy][i + 2 + dx];
      } else {  // across a pole: the edge row, turned
        const int edge = rn < 0 ? 0 : H - 1;
        const long g = (long)edge * W +
                       wrap_col(c + dx + (rn < 0 ? turn_s : turn_n), W);
        nh = __ldg(hb + g);
        ns = __ldg(sel + g);
      }
      open |= !interesting(nh, ns);
    }
    if (code != 0 && open) bits |= 1 << 16;
    const long g = (long)r * W + c;
    code_out[g] = code;
    packed_out[g] = bits;
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
    directions_kernel(const float* __restrict__ hb,
                      const float* __restrict__ sel,
                      const float* __restrict__ q,
                      const float* __restrict__ dx8,
                      int* __restrict__ code_out,
                      int* __restrict__ packed_out, int H, int W, float dy8,
                      int turn_s, int turn_n, int wrap) {
  __shared__ float sh[kHaloY][kHaloX];
  __shared__ float ss[kHaloY][kHaloX];
  const int r0 = blockIdx.y * kTileY, c0 = blockIdx.x * kTileX;
  const int tid = threadIdx.x;

  for (int k = tid; k < kHaloY * kHaloX; k += kThreads) {
    const int j = k / kHaloX, i = k % kHaloX;
    const long g = (long)clamp_row(r0 - 2 + j, H) * W +
                   wrap_col(c0 - 2 + i, W);
    sh[j][i] = __ldg(hb + g);
    ss[j][i] = __ldg(sel + g);
  }
  __syncthreads();

  if constexpr (kPacked) {
    packed_tile(sh, ss, hb, sel, q, dx8, code_out, packed_out, r0, c0, H, W,
                dy8, turn_s, turn_n, wrap);
  } else {
    for (int k = tid; k < kTileY * kTileX; k += kThreads) {
      const int j = k / kTileX, i = k % kTileX;
      const int r = r0 + j, c = c0 + i;
      if (r >= H || c >= W) continue;
      const long g = (long)r * W + c;
      code_out[g] = d8_code(sh, ss, j + 2, i + 2, __ldg(q + g),
                            __ldg(dx8 + r), dy8);
    }
  }
}

template <bool kPacked>
int launch(const float* hb, const float* sel, const float* q,
           const float* dx8, int* code, int* packed, int H, int W, float dy8,
           int turn_s, int turn_n, int wrap, int ty, int tx, void* stream) {
  if (ty != kTileY || tx != kTileX || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  directions_kernel<kPacked><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      hb, sel, q, dx8, code, packed, H, W, dy8, turn_s, turn_n, wrap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// codes (H, W) int from the blurred height and the selection; q (H, W)
// tie-break noise, dx8 (H,) = 8 dx per row of the coordsMod grid; (ty, tx)
// the caller's tile, refused unless it is the one compiled here.
int demiurge_flow_directions(const float* hb, const float* sel,
                             const float* q, const float* dx8, int* code,
                             int H, int W, float dy8, int ty, int tx,
                             void* stream) {
  return launch<false>(hb, sel, q, dx8, code, nullptr, H, W, dy8, 0, 0, 1,
                       ty, tx, stream);
}

// the codes and the packed masks; turn_s, turn_n, wrap as the kernel takes
// them
int demiurge_flow_directions_packed(const float* hb, const float* sel,
                                    const float* q, const float* dx8,
                                    int* code, int* packed, int H, int W,
                                    float dy8, int turn_s, int turn_n,
                                    int wrap, int ty, int tx, void* stream) {
  return launch<true>(hb, sel, q, dx8, code, packed, H, W, dy8, turn_s,
                      turn_n, wrap, ty, tx, stream);
}

}  // extern "C"

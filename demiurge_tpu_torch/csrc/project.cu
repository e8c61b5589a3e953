// The ocean's projection, for Hopper (sm_90a): the whole single-card
// `project` stage of ops/ocean.py in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves `project`
// (demiurge_tpu/ops/ocean.py:596) to XLA's fusion, as K12's note says of
// its sweep.  On the card its plain twin, ops.ocean.project, is a chain
// of about 265 whole-field torch ops (shifts, selects, the atan2 and the
// 8-direction scan), each a launch that reads and writes whole planes.
//
// Per pixel, as the twin: the pressure gradient subtracted from (u, v),
// each one-sided tap replaced by the centre where the neighbour is land;
// the coastal free-slip redirect, (u, v) turned toward the open direction
// of 8 whose index lies nearest the velocity's angle in eighths of a turn
// (theta), where the two directions bracketing theta are not both open;
// the land mask.  The arithmetic repeats the twin's torch ops one by one,
// each explicitly rounded (no FMA contraction), so the result equals the
// twin on the card bit for bit: a torch op divides by a Python scalar as
// a multiply by the scalar's float32 reciprocal (div_true_kernel_cuda), so
// do the / pressurefactor and the / PI here, while the divisions by the
// per-row tables are true divisions; torch.remainder is fmod plus the
// divisor where the signs differ; .to(int32) truncates (NaN -> 0); atan2
// and sqrt are CUDA's atan2f and the correctly rounded square root, as
// torch calls them; the scan overwrites on a strict <, in the twin's
// order of directions.
//
// Bound on this card: device-memory bytes.  The stage reads u, v, p and
// the terrain once and writes u and v once, 24 bytes a pixel (805 MB,
// 0.240 ms at 8192x4096 and 3.35 TB/s); what these inputs need is less:
// a land pixel's output is 0 whatever its u, v and p, and a sea pixel
// reads p only at sea neighbours, so 12 bytes a land pixel.  The twin
// moves each plane once per op.  The arithmetic is not free: two true
// divisions a component, atan2f and the 8-direction scan are ~250
// instructions a pixel, enough to make the kernel issue-bound (0.51 ms at
// 8192x4096) when every pixel runs them.
// Design: one thread a pixel, its taps read through L1 (neighbouring
// threads share them; a shared-memory tile with a halo, raced, moved the
// same bytes 28% slower, PERF.md section 6); a pixel off the grid's
// outer ring takes them at fixed offsets from one address.  The work
// follows what the pixel needs: a land pixel writes its zeros and reads
// nothing more; a sea pixel with no land among its 8 neighbours stops
// after the pressure gradient, since the redirect cannot fire there; only
// coastal pixels take the angle and the scan.  At 8192x4096 that is 0.230
// ms on the CLI's terrain (77% land) and 0.41 ms with no land at all, 64%
// and 59% of what those inputs need (PERF.md section 6 has the block
// shapes and land shares raced).
//
// The taps follow core.topology.shift on an x-periodic grid: columns
// wrap mod W; the row beyond a pole (wrap_s, wrap_n) is the edge row read
// pole_shift (W/2) columns over, and a diagonal tap there is the column
// roll first, then the reflection: tap (dx, -1) of pixel (0, c) is
// (0, c + dx + pole_shift); a grid edge that is not a pole clamps to the
// edge row.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

// The stage's scalars, each the float32 that torch makes of the Python
// number the twin writes (ops/ocean.py project_scalars, same order).
struct ProjectScalars {
  float inv_pf;     // 1 / pressurefactor, in float32
  float inv_pi;     // 1 / PI, in float32
  float two_pi;     // 2 * PI: the scan's first difference
  float dir_x[8];   // dx / |(dx, dy)| of the 8 directions, twin's order
  float dir_y[8];
};
constexpr int kNumScalars = sizeof(ProjectScalars) / sizeof(float);

// the 8 directions of the redirect, in the twin's order: (1, 0), (1, 1),
// (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)
__device__ __forceinline__ int dir_x(int i) {
  return (i <= 1 || i == 7) ? 1 : ((i >= 3 && i <= 5) ? -1 : 0);
}
__device__ __forceinline__ int dir_y(int i) {
  return (i >= 1 && i <= 3) ? 1 : (i >= 5 ? -1 : 0);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.remainder(x, 8.0): fmod, plus 8 where the signs differ.  On
// [0, 16), where theta and its floor and ceiling lie, that is x or the
// exact x - 8 (Sterbenz), without fmodf's general reduction.
__device__ __forceinline__ float rem8(float x) {
  if (x >= 0.0f && x < 16.0f) return x >= 8.0f ? sub(x, 8.0f) : x;
  const float m = fmodf(x, 8.0f);
  return (m != 0.0f && signbit(m)) ? add(m, 8.0f) : m;
}

// The grid row and the column offset that the tap row `gr` (from -1 to
// H) reads: beyond a pole the edge row pole_shift columns over, beyond
// another edge the edge row itself.
__device__ __forceinline__ void halo_row(int gr, int H, int wrap_s,
                                         int wrap_n, int pole_shift,
                                         int& row, int& col_off) {
  row = gr;
  col_off = 0;
  if (gr < 0) {
    row = 0;
    col_off = wrap_s ? pole_shift : 0;
  } else if (gr >= H) {
    row = H - 1;
    col_off = wrap_n ? pole_shift : 0;
  }
}

// The taps of pixel (r, c): the terrain at all 9 (hh[1 + dy][1 + dx]),
// the pressure at the centre and the 4 sides (pp, same layout).  Off the
// grid's outer ring they are the plain neighbours, one base address and
// fixed offsets; on the ring each tap row goes through halo_row and each
// column wraps mod W (c + dx + col_off < 2W, as col_off < W).
__device__ __forceinline__ void load_taps(const float* __restrict__ p,
                                          const float* __restrict__ terrain,
                                          int r, int c, int H, int W,
                                          int wrap_s, int wrap_n,
                                          int pole_shift, float (&hh)[3][3],
                                          float (&pp)[3][3]) {
  if (r > 0 && r < H - 1 && c > 0 && c < W - 1) {
    const long i = (long)r * W + c;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const long j = i + (long)dy * W + dx;
        hh[1 + dy][1 + dx] = __ldg(terrain + j);
        if (dx == 0 || dy == 0) pp[1 + dy][1 + dx] = __ldg(p + j);
      }
    return;
  }
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    int row, col_off;
    halo_row(r + dy, H, wrap_s, wrap_n, pole_shift, row, col_off);
    const long base = (long)row * W;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      int col = c + dx + col_off;
      if (col < 0) col += W;
      if (col >= W) col -= W;
      hh[1 + dy][1 + dx] = __ldg(terrain + base + col);
      if (dx == 0 || dy == 0) pp[1 + dy][1 + dx] = __ldg(p + base + col);
    }
  }
}

// ops/ocean.py project for one sea pixel, from its taps; pwx and area
// the row's tables, pwy the grid's.  The redirect's angle and scan run
// only where a neighbour is land: elsewhere neither direction bracketing
// theta can be blocked, so the twin keeps (fu, fv) whatever theta is.
__device__ __forceinline__ void project_sea_pixel(
    float uu, float vv, const float (&hh)[3][3], const float (&pp)[3][3],
    float pwx, float area, float pwy, const ProjectScalars& sc,
    float& out_u, float& out_v) {
  const float pc = pp[1][1];
  const float pE = hh[1][2] > 0.0f ? pc : pp[1][2];
  const float pW = hh[1][0] > 0.0f ? pc : pp[1][0];
  const float pN = hh[2][1] > 0.0f ? pc : pp[2][1];
  const float pS = hh[0][1] > 0.0f ? pc : pp[0][1];
  float fu = sub(uu, mul(dvd(dvd(mul(0.5f, sub(pE, pW)), pwx), area),
                         sc.inv_pf));
  float fv = sub(vv, mul(dvd(dvd(mul(0.5f, sub(pN, pS)), pwy), area),
                         sc.inv_pf));

  unsigned blocked = 0;  // bit i: direction i's neighbour is land
#pragma unroll
  for (int i = 0; i < 8; ++i)
    blocked |= (unsigned)(hh[1 + dir_y(i)][1 + dir_x(i)] > 0.0f) << i;
  if (blocked != 0) {
    // ((atan2(fv, fu) / PI + 1) / 2 * 8 + 4) mod 8
    const float theta = rem8(add(
        mul(mul(add(mul(atan2f(fv, fu), sc.inv_pi), 1.0f), 0.5f), 8.0f),
        4.0f));
    const int lower = __float2int_rz(rem8(floorf(theta)));
    const int upper = __float2int_rz(rem8(ceilf(theta)));
    const bool border =
        ((unsigned)lower < 8u && ((blocked >> lower) & 1u)) ||
        ((unsigned)upper < 8u && ((blocked >> upper) & 1u));
    if (border) {
      // the twin's scan: the first open direction of least
      // min(2 PI - |i - theta|, |i - theta|) below 2 PI (both NaN or
      // neither, so fminf is torch.minimum here)
      int best = -1;
      float difference = sc.two_pi;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = fabsf(sub((float)i, theta));
        const float ang = fminf(sub(sc.two_pi, d), d);
        if (ang < difference && !((blocked >> i) & 1u)) {
          best = i;
          difference = ang;
        }
      }
      if (best >= 0) {
        const float mag = __fsqrt_rn(add(mul(fu, fu), mul(fv, fv)));
        float ux = 0.0f, uy = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (best == i) {
            ux = sc.dir_x[i];
            uy = sc.dir_y[i];
          }
        fu = mul(mag, ux);
        fv = mul(mag, uy);
      }
    }
  }
  out_u = fu;
  out_v = fv;
}

// tab: [pwx (H) | area (H) | pwy (1)].  One thread a pixel; a block of
// blockDim.y rows x blockDim.x columns.  A land pixel holds zero velocity
// and reads nothing more.
__global__ void project_kernel(const float* __restrict__ u,
                               const float* __restrict__ v,
                               const float* __restrict__ p,
                               const float* __restrict__ terrain,
                               const float* __restrict__ tab,
                               const ProjectScalars sc,
                               float* __restrict__ fu,
                               float* __restrict__ fv, int H, int W,
                               int wrap_s, int wrap_n, int pole_shift) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= W || r >= H) return;
  const long i = (long)r * W + c;
  if (__ldg(terrain + i) > 0.0f) {
    fu[i] = 0.0f;
    fv[i] = 0.0f;
    return;
  }
  float hh[3][3], pp[3][3];
  load_taps(p, terrain, r, c, H, W, wrap_s, wrap_n, pole_shift, hh, pp);
  project_sea_pixel(__ldg(u + i), __ldg(v + i), hh, pp, __ldg(tab + r),
                    __ldg(tab + H + r), __ldg(tab + 2 * H), sc, fu[i],
                    fv[i]);
}

}  // namespace

extern "C" {

// The whole projection stage.  tables: device, 2H + 1 floats (layout
// above); scalars: host, nscalars floats in ProjectScalars' order; a
// block of th rows x tw columns of pixels (tw a multiple of 32, at most
// 1024 threads).
int demiurge_project_stage(const float* u, const float* v, const float* p,
                           const float* terrain, const float* tables,
                           const float* scalars, int nscalars, float* fu,
                           float* fv, int H, int W, int wrap_s, int wrap_n,
                           int pole_shift, int th, int tw, void* stream) {
  if (nscalars != kNumScalars || H < 1 || W < 1 || pole_shift < 0 ||
      pole_shift >= W || th < 1 || tw < 32 || tw % 32 != 0 ||
      th * tw > 1024)
    return (int)cudaErrorInvalidValue;
  ProjectScalars sc;
  memcpy(&sc, scalars, sizeof(sc));
  const dim3 block(tw, th);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th);
  project_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, p, terrain, tables, sc, fu, fv, H, W, wrap_s, wrap_n,
      pole_shift);
  return (int)cudaGetLastError();
}

}  // extern "C"

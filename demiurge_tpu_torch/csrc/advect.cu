// The ocean's semi-Lagrangian advect, for Hopper (sm_90a): the tap sampler
// alone, or the whole single-card advect stage in one launch.
//
// Replaces demiurge_tpu/pallas_kernels/advect.py:
//   - advect_sample_tiered (:235, _kernel_dyn :127): latitude-tiered tap
//     sampler, one (rx, q) pair per 32-row strip;
//   - with a constant table (rx = Rx, q = 0 on every row) the same kernel
//     computes advect_sample_pallas (:297, _kernel :39) and the XLA
//     global-radius tap loop of ops.ocean._advect_sample_fast.
//
// The TPU kernel sums (u, v) over every integer tap (kx, ky) of the strip's
// radius with hat weights, because a gather is slow there.  Only the two
// taps bracketing the displacement in each direction carry weight, so this
// kernel computes the same sum in closed form (tap_sum):
//   - rows: ky in {floor(dy), floor(dy)+1} within [-Ry, Ry], weight
//     hat(dy - ky), the row clamped to [0, H-1];
//   - fine case (|dx| <= rx, or |dx| <= Rf in a polar strip, q > 0): kx in
//     {floor(dx), floor(dx)+1} within [-rx, rx] (resp. [-Rf, Rf]), weight
//     hat(dx - kx), the column taken mod W;
//   - coarse case (polar strip, |dx| > Rf; or a non-polar strip given an
//     unclamped |dx| > rx, where q = 0 leaves the single tap kx = 0): kx on
//     the stride lattice, {S*floor(dx/S), that + S} within [-S*q, S*q],
//     weight hat((dx - kx)/S).
// The polar hybrid is kept on purpose: the port on the card reproduces the
// reference's device numbers, not a plain bilinear fetch there.  The taps
// are summed in the TPU kernel's order (ky ascending, then kx ascending)
// with explicitly rounded products and sums, so the result equals the
// plain PyTorch tap sum (kernels/advect.py) bit for bit; the TPU kernel
// adds only zero-weight taps beyond these.
//
// Two forms of one kernel (advect_kernel<kStage>):
//   - the sampler (kStage = false): (dx, dy) in, the sampled (u, v) out;
//   - the stage (kStage = true): everything ops/ocean.py advect computes
//     on one card, per pixel: the great-circle backtrace (_departure), the
//     clamp of (dx, dy) to the strip's rx and to Ry, the tap sum, the
//     parallel transport back, NaN -> 0, Coriolis, dissipation, the wind
//     stress and drag, and the land mask.  It reads u, v and the terrain
//     and writes the new (u, v): the plain composition's ~100 launches in
//     one.  sin/cos of the pixel centres' longitude and latitude and the
//     wind profile come in as one per-grid table, built by the twin's own
//     torch ops.  The arithmetic repeats the twin's torch ops on the card
//     one by one, each explicitly rounded: a torch op divides by a Python
//     scalar as a multiply by the scalar's float32 reciprocal
//     (div_true_kernel_cuda), so do s2, t2 and the Coriolis' /5000 here;
//     1/x is a correctly rounded reciprocal; x**2 is x*x; x**(-2/24) is
//     powf (torch's pow_tensor_scalar); sin, cos, atan2 and asin are the
//     CUDA libm's, as torch calls them.
//
// Bound on this card: device-memory bytes.  The stage reads three planes
// and writes two (42 MB at 2048x1024); its taps are re-reads of (u, v)
// that neighbouring threads share through L1 (adjacent columns read
// adjacent addresses).  The polar strips' wide radius costs nothing extra
// here, where on the TPU it cost 2q+1 rolled copies per tap row.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kBlockX = 128;
constexpr int kMaxStrips = 256;  // 32-row strips up to H = 8192

// The per-strip (rx, q) table, passed by value in the launch's parameter
// space: no device allocation and no host-to-device copy per call.
struct StripTable {
  int rx[kMaxStrips];
  int q[kMaxStrips];
};

// The stage's scalars, each the float32 that torch makes of the Python
// number the twin writes (kernels/advect.py stage_scalars, same order).
struct StageScalars {
  float k_arc;        // 2 * REF_PI / circumference
  float timestep;
  float lam0, inv_dlam, phi0, inv_dphi;  // spheric_to_tex: (x - x0) * 1/dx
  float width, height;
  float cor;          // Coriolis scale; 0 = none
  float wz_neg, wz;   // -1/24 and 1/24
  float inv_5000;
  float dissipation;
  float stress_k;     // 0.0001
  float stress_exp;   // -2/24
  float drag;         // 1 - 0.4**(1/24)
};
constexpr int kNumScalars = sizeof(StageScalars) / sizeof(float);

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

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

// ops/ocean.py _rotate, term for term: (px, py, pz) rotated by theta about
// the unit axis (ux, uy, uz)
__device__ __forceinline__ void rotate(float theta, float ux, float uy,
                                       float uz, float px, float py,
                                       float pz, float& rx, float& ry,
                                       float& rz) {
  const float c = cosf(theta);
  const float s = sinf(theta);
  const float omc = sub(1.0f, c);
  rx = add(add(mul(add(c, mul(mul(ux, ux), omc)), px),
               mul(sub(mul(mul(ux, uy), omc), mul(uz, s)), py)),
           mul(add(mul(mul(ux, uz), omc), mul(uy, s)), pz));
  ry = add(add(mul(add(mul(mul(uy, ux), omc), mul(uz, s)), px),
               mul(add(c, mul(mul(uy, uy), omc)), py)),
           mul(sub(mul(mul(uy, uz), omc), mul(ux, s)), pz));
  rz = add(add(mul(sub(mul(mul(uz, ux), omc), mul(uy, s)), px),
               mul(add(mul(mul(uz, uy), omc), mul(ux, s)), py)),
           mul(add(c, mul(mul(uz, uz), omc)), pz));
}

// the tap (r + ky, c + kx) of (u, v): row clamped, column mod W
struct GlobalTaps {
  const float* __restrict__ u;
  const float* __restrict__ v;
  int r, c, H, W;
  __device__ __forceinline__ void operator()(int ky, int kx, float& tu,
                                             float& tv) const {
    int rr = r + ky;
    rr = rr < 0 ? 0 : (rr > H - 1 ? H - 1 : rr);
    int col = (c + kx) % W;
    if (col < 0) col += W;
    const long j = (long)rr * W + col;
    tu = __ldg(u + j);
    tv = __ldg(v + j);
  }
};

// the closed-form tap sum of the module comment
__device__ __forceinline__ void tap_sum(const GlobalTaps& taps, float ddx,
                                        float ddy, int rx, int q, int Ry,
                                        int Rf, int stride, float& ou,
                                        float& ov) {
  if (isnan(ddx) || isnan(ddy)) {
    ou = ddx + ddy;
    ov = ddx + ddy;
    return;
  }
  const int fine_r = q > 0 ? Rf : rx;
  const bool fine = fabsf(ddx) <= (float)fine_r;
  // tap lattice: unit spacing out to fine_r, or `stride` out to stride*q
  const float step = fine ? 1.0f : (float)stride;
  const float reach = fine ? (float)fine_r : (float)(stride * q);
  // a fine tap's step is 1, and x / 1 == x: its divisions are skipped
  const float kx0 =
      fine ? floorf(ddx) : __fmul_rn(floorf(__fdiv_rn(ddx, step)), step);
  const float ky0 = floorf(ddy);

  float acc_u = 0.0f, acc_v = 0.0f;
  for (int jy = 0; jy < 2; ++jy) {
    const float ky = ky0 + (float)jy;
    if (fabsf(ky) > (float)Ry) continue;
    const float wy = hat(__fsub_rn(ddy, ky));
    for (int jx = 0; jx < 2; ++jx) {
      const float kx = __fadd_rn(kx0, __fmul_rn((float)jx, step));
      if (fabsf(kx) > reach) continue;
      const float d = __fsub_rn(ddx, kx);
      const float wx = hat(fine ? d : __fdiv_rn(d, step));
      const float w = __fmul_rn(wy, wx);
      float tu, tv;
      taps((int)ky, (int)kx, tu, tv);
      acc_u = __fadd_rn(acc_u, __fmul_rn(w, tu));
      acc_v = __fadd_rn(acc_v, __fmul_rn(w, tv));
    }
  }
  ou = acc_u;
  ov = acc_v;
}

// What the backtrace leaves for the transport back.
struct Departure {
  float ddx, ddy;                  // the clamped displacement, pixels
  float qx, qy, qz, ax, ay, az, arc;
  float ex, ey, nx, ny, nz;        // the pixel's tangent basis
};

// ops/ocean.py _departure and _advect_sample_fast's clamp, for the pixel
// (r, c) with velocity (uu, vv)
__device__ __forceinline__ Departure departure(
    float uu, float vv, const float* __restrict__ tab,
    const StageScalars& sc, int r, int c, int H, int W, int rx, int Ry) {
  Departure d;
  const float sin_lam = __ldg(tab + c), cos_lam = __ldg(tab + W + c);
  const float sin_phi = __ldg(tab + 2 * W + r);
  const float cos_phi = __ldg(tab + 2 * W + H + r);
  const float speed = __fsqrt_rn(add(mul(uu, uu), mul(vv, vv)));
  d.arc = mul(mul(speed, sc.k_arc), sc.timestep);
  const float px = mul(cos_phi, cos_lam), py = mul(cos_phi, sin_lam);
  const float pz = sin_phi;
  d.ex = -sin_lam;
  d.ey = cos_lam;
  d.nx = mul(-sin_phi, cos_lam);
  d.ny = mul(-sin_phi, sin_lam);
  d.nz = cos_phi;
  const float cx = add(mul(uu, d.ex), mul(vv, d.nx));
  const float cy = add(mul(uu, d.ey), mul(vv, d.ny));
  const float cz = mul(vv, d.nz);
  const float ax = sub(mul(py, cz), mul(pz, cy));
  const float ay = sub(mul(pz, cx), mul(px, cz));
  const float az = sub(mul(px, cy), mul(py, cx));
  const float an = __fsqrt_rn(add(add(mul(ax, ax), mul(ay, ay)),
                                  mul(az, az)));
  const float safe = clamp_min_nan(an, 1e-30f);
  d.ax = dvd(ax, safe);
  d.ay = dvd(ay, safe);
  d.az = dvd(az, safe);
  rotate(-d.arc, d.ax, d.ay, d.az, px, py, pz, d.qx, d.qy, d.qz);
  const float lam2 = atan2f(d.qy, d.qx);
  const float phi2 = asinf(clamp_nan(d.qz, -1.0f, 1.0f));
  const float s2 = mul(sub(lam2, sc.lam0), sc.inv_dlam);
  const float t2 = mul(sub(phi2, sc.phi0), sc.inv_dphi);
  const float rxf = (float)rx, ryf = (float)Ry;
  d.ddx = clamp_nan(sub(sub(mul(s2, sc.width), 0.5f), (float)c), -rxf, rxf);
  d.ddy = clamp_nan(sub(sub(mul(t2, sc.height), 0.5f), (float)r), -ryf, ryf);
  return d;
}

// ops/ocean.py _advect_finish: the sampled (su, sv) transported back, NaN
// -> 0, Coriolis, dissipation, wind stress and drag, the land mask
__device__ __forceinline__ void finish(const Departure& d, float su,
                                       float sv, float wxr, float wyr,
                                       float terrain, const StageScalars& sc,
                                       float& out_u, float& out_v) {
  const float cp2 = __fsqrt_rn(add(mul(d.qx, d.qx), mul(d.qy, d.qy)));
  const float inv_cp2 = dvd(1.0f, clamp_min_nan(cp2, 1e-30f));
  const float cl2 = mul(d.qx, inv_cp2), sl2 = mul(d.qy, inv_cp2);
  const float e2x = -sl2, e2y = cl2;
  const float n2x = mul(-d.qz, cl2), n2y = mul(-d.qz, sl2), n2z = cp2;
  const float tx0 = add(mul(su, e2x), mul(sv, n2x));
  const float ty0 = add(mul(su, e2y), mul(sv, n2y));
  const float tz0 = mul(sv, n2z);
  float tx, ty, tz;
  rotate(d.arc, d.ax, d.ay, d.az, tx0, ty0, tz0, tx, ty, tz);
  float nu = add(mul(tx, d.ex), mul(ty, d.ey));
  float nv = add(add(mul(tx, d.nx), mul(ty, d.ny)), mul(tz, d.nz));
  if (isnan(nu) || isnan(nv)) {
    nu = 0.0f;
    nv = 0.0f;
  }
  if (sc.cor != 0.0f) {
    const float vcx = add(mul(nu, d.ex), mul(nv, d.nx));
    const float vcy = add(mul(nu, d.ey), mul(nv, d.ny));
    const float acx = mul(-2.0f, mul(sc.wz_neg, vcy));
    const float acy = mul(-2.0f, mul(sc.wz, vcx));
    const float du = add(mul(acx, d.ex), mul(acy, d.ey));
    const float dv = add(add(mul(acx, d.nx), mul(acy, d.ny)),
                         mul(0.0f, d.nz));
    nu = add(nu, mul(mul(mul(du, sc.timestep), sc.inv_5000), sc.cor));
    nv = add(nv, mul(mul(mul(dv, sc.timestep), sc.inv_5000), sc.cor));
  }
  nu = mul(sc.dissipation, nu);
  nv = mul(sc.dissipation, nv);
  const float gx = fabsf(sub(wxr, nu)), gy = fabsf(sub(wyr, nv));
  const float sx = add(1.0f, mul(sc.stress_k, mul(gx, gx)));
  const float sy = add(1.0f, mul(sc.stress_k, mul(gy, gy)));
  nu = sub(add(nu, mul(wxr, sub(1.0f, powf(sx, sc.stress_exp)))),
           mul(nu, sc.drag));
  nv = sub(add(nv, mul(wyr, sub(1.0f, powf(sy, sc.stress_exp)))),
           mul(nv, sc.drag));
  if (terrain > 0.0f) {  // solid cells hold zero velocity
    nu = 0.0f;
    nv = 0.0f;
  }
  out_u = nu;
  out_v = nv;
}

// kStage = false: in0 = dx, in1 = dy, the sampled (u, v) out.
// kStage = true: in0 = terrain, tab = the per-grid table
// [sin_lam (W) | cos_lam (W) | sin_phi (H) | cos_phi (H) | wx (H) | wy (H)],
// the stage's new (u, v) out.  One thread a pixel, the taps gathered
// through L1: a design that staged each row tile's tap window in shared
// memory by cp.async, the backtrace computed while the copies flew, lost
// to this one by 2% at 2048x1024 (PERF.md section 6), since the taps hit
// L1 either way and the pixel's arithmetic and libm calls dominate.
template <bool kStage>
__global__ void advect_kernel(const float* __restrict__ u,
                              const float* __restrict__ v,
                              const float* __restrict__ in0,
                              const float* __restrict__ in1,
                              const float* __restrict__ tab,
                              const StripTable meta, const StageScalars sc,
                              int strip_rows, float* __restrict__ ou,
                              float* __restrict__ ov, int H, int W, int Ry,
                              int Rf, int stride) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;
  const long i = (long)r * W + c;
  const int s = r / strip_rows;
  const int rx = meta.rx[s];
  const int q = meta.q[s];
  const GlobalTaps taps{u, v, r, c, H, W};
  float su, sv;
  if (!kStage) {
    tap_sum(taps, in0[i], in1[i], rx, q, Ry, Rf, stride, su, sv);
    ou[i] = su;
    ov[i] = sv;
    return;
  }
  const Departure d = departure(u[i], v[i], tab, sc, r, c, H, W, rx, Ry);
  tap_sum(taps, d.ddx, d.ddy, rx, q, Ry, Rf, stride, su, sv);
  finish(d, su, sv, __ldg(tab + 2 * W + 2 * H + r),
         __ldg(tab + 2 * W + 3 * H + r), in0[i], sc, ou[i], ov[i]);
}

bool fill_table(const int* meta, int nstrips, int strip_rows, int H,
                StripTable* table) {
  if (nstrips < 1 || nstrips > kMaxStrips || nstrips * strip_rows != H)
    return false;
  for (int s = 0; s < nstrips; ++s) {
    table->rx[s] = meta[2 * s];
    table->q[s] = meta[2 * s + 1];
  }
  return true;
}

}  // namespace

extern "C" {

// meta: host array of nstrips (rx, q) int pairs, nstrips * strip_rows == H.
int demiurge_advect_sample(const float* u, const float* v, const float* dx,
                           const float* dy, const int* meta, int nstrips,
                           int strip_rows, float* ou, float* ov, int H, int W,
                           int Ry, int Rf, int stride, void* stream) {
  StripTable table;
  if (!fill_table(meta, nstrips, strip_rows, H, &table))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  advect_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, dx, dy, nullptr, table, StageScalars{}, strip_rows, ou, ov, H, W,
      Ry, Rf, stride);
  return (int)cudaGetLastError();
}

// The whole advect stage.  tables: device, 2W + 4H floats (layout above);
// scalars: host, nscalars floats in StageScalars' order; meta as above,
// and rx of a strip is also its clamp of dx, Ry the clamp of dy.
int demiurge_advect_stage(const float* u, const float* v,
                          const float* terrain, const float* tables,
                          const int* meta, int nstrips, int strip_rows,
                          const float* scalars, int nscalars, float* ou,
                          float* ov, int H, int W, int Ry, int Rf,
                          int stride, void* stream) {
  StripTable table;
  if (!fill_table(meta, nstrips, strip_rows, H, &table) ||
      nscalars != kNumScalars)
    return (int)cudaErrorInvalidValue;
  StageScalars sc;
  memcpy(&sc, scalars, sizeof(sc));
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  advect_kernel<true><<<grid, kBlockX, 0, (cudaStream_t)stream>>>(
      u, v, terrain, nullptr, tables, table, sc, strip_rows, ou, ov, H, W,
      Ry, Rf, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"

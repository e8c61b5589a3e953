// Semi-Lagrangian velocity sampler of the ocean advect, for Hopper (sm_90a).
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
// kernel computes the same sum in closed form, one thread per pixel:
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
// Bound on this card: device-memory bytes — it reads u, v, dx, dy and
// writes two fields, 50 MB at 2048x1024, plus the taps, which neighbouring
// threads share through L1/L2 (adjacent columns read adjacent addresses).
// The polar strips' wide radius costs nothing extra here, where on the TPU
// it cost 2q+1 rolled copies per tap row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 128;
constexpr int kMaxStrips = 256;  // 32-row strips up to H = 8192

// The per-strip (rx, q) table, passed by value in the launch's parameter
// space: no device allocation and no host-to-device copy per call.
struct StripTable {
  int rx[kMaxStrips];
  int q[kMaxStrips];
};

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

__global__ void advect_sample_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const StripTable meta, int strip_rows, float* __restrict__ ou,
    float* __restrict__ ov, int H, int W, int Ry, int Rf, int stride) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;
  const long i = (long)r * W + c;
  const float ddx = dx[i];
  const float ddy = dy[i];
  if (isnan(ddx) || isnan(ddy)) {
    ou[i] = ddx + ddy;
    ov[i] = ddx + ddy;
    return;
  }
  const int s = r / strip_rows;
  const int rx = meta.rx[s];
  const int q = meta.q[s];
  const int fine_r = q > 0 ? Rf : rx;
  const bool fine = fabsf(ddx) <= (float)fine_r;
  // tap lattice: unit spacing out to fine_r, or `stride` out to stride*q
  const float step = fine ? 1.0f : (float)stride;
  const float reach = fine ? (float)fine_r : (float)(stride * q);
  const float kx0 = __fmul_rn(floorf(__fdiv_rn(ddx, step)), step);
  const float ky0 = floorf(ddy);

  float acc_u = 0.0f, acc_v = 0.0f;
  for (int jy = 0; jy < 2; ++jy) {
    const float ky = ky0 + (float)jy;
    if (fabsf(ky) > (float)Ry) continue;
    const float wy = hat(__fsub_rn(ddy, ky));
    int rr = r + (int)ky;
    rr = rr < 0 ? 0 : (rr > H - 1 ? H - 1 : rr);
    const long row = (long)rr * W;
    for (int jx = 0; jx < 2; ++jx) {
      const float kx = __fadd_rn(kx0, __fmul_rn((float)jx, step));
      if (fabsf(kx) > reach) continue;
      const float wx = hat(__fdiv_rn(__fsub_rn(ddx, kx), step));
      const float w = __fmul_rn(wy, wx);
      int col = (c + (int)kx) % W;
      if (col < 0) col += W;
      acc_u = __fadd_rn(acc_u, __fmul_rn(w, __ldg(u + row + col)));
      acc_v = __fadd_rn(acc_v, __fmul_rn(w, __ldg(v + row + col)));
    }
  }
  ou[i] = acc_u;
  ov[i] = acc_v;
}

}  // namespace

extern "C" {

// meta: host array of nstrips (rx, q) int pairs, nstrips * strip_rows == H.
int demiurge_advect_sample(const float* u, const float* v, const float* dx,
                           const float* dy, const int* meta, int nstrips,
                           int strip_rows, float* ou, float* ov, int H, int W,
                           int Ry, int Rf, int stride, void* stream) {
  if (nstrips < 1 || nstrips > kMaxStrips || nstrips * strip_rows != H)
    return (int)cudaErrorInvalidValue;
  StripTable table;
  for (int s = 0; s < nstrips; ++s) {
    table.rx[s] = meta[2 * s];
    table.q[s] = meta[2 * s + 1];
  }
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  advect_sample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, dx, dy, table, strip_rows, ou, ov, H, W, Ry, Rf, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Substeps of the climate model's energy balance, for Hopper (sm_90a).
//
// Replaces demiurge_tpu/pallas_kernels/climate.py: climate_step_pallas
// (:132, _kernel :90, with _row_shifts :70 and the pole halos of
// _pad_rows_reflect :58).
//
// One launch is one substep, out of place (ping-pong buffers), one thread
// per pixel:
//     S(c)  = T[north][c] + T[south][c]
//     lap   = 2 * (S(c + kneg_r) + S(c + kpos_r)) - 8 * T
//     Tk    = T + 273.15;  olr = olr_coef * ((Tk * Tk) * (Tk * Tk))
//     T'    = T + ((asr[s][r] - olr) + D * lap) * cinv
// — the corner-tap sum of the TPU kernel (the straight taps of the
// spherical Laplacian cancel in lx + ly).  kneg/kpos are the per-row
// NEAREST column shifts of the 1/cos(phi)-stretched corner taps, a (2, H)
// table built once per grid.  The TPU kernel stages row bands with K-deep
// pole halos (antipodal mirrors) and barrel-rolls the shifted taps through
// log2(W) select stages; here the thread indexes the neighbour row
// directly: beyond a pole it is the edge row itself at column
// c + pole_shift, elsewhere the grid clamps.  That serves every grid size,
// not only H % 128 == 0.  asr is the (K, H) insolation table of the K
// substeps, built on the device by the caller.
//
// Bound on this card: device-memory bytes.  A substep reads T and cinv and
// writes T (25 MB at 2048x1024, all of it L2-resident between the launches
// of a 10-substep step) against about 20 flops a pixel.  The sums are
// evaluated in the plain twin's order with explicitly rounded operations
// (no FMA contraction), so the result equals kernels/climate.py's
// climate_step_plain bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 128;

__device__ __forceinline__ int wrap_col(int c, int W) {
  c %= W;
  return c < 0 ? c + W : c;
}

__global__ void climate_substep_kernel(
    const float* __restrict__ T, const float* __restrict__ cinv,
    const float* __restrict__ asr_row, const int* __restrict__ shifts,
    float* __restrict__ out, int H, int W, int wrap_s, int wrap_n,
    int pole_shift, float diff_scale, float olr_coef) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;

  // north / south rows and their column offset (half a world beyond a
  // pole, none elsewhere)
  int rn = r + 1, on = 0;
  if (rn == H) {
    rn = H - 1;
    if (wrap_n) on = pole_shift;
  }
  int rs = r - 1, os = 0;
  if (rs < 0) {
    rs = 0;
    if (wrap_s) os = pole_shift;
  }
  const float* __restrict__ north = T + (long)rn * W;
  const float* __restrict__ south = T + (long)rs * W;
  const int cl = c + __ldg(shifts + r);
  const int cr = c + __ldg(shifts + H + r);
  const float left = __fadd_rn(__ldg(north + wrap_col(cl + on, W)),
                               __ldg(south + wrap_col(cl + os, W)));
  const float right = __fadd_rn(__ldg(north + wrap_col(cr + on, W)),
                                __ldg(south + wrap_col(cr + os, W)));

  const long i = (long)r * W + c;
  const float t = __ldg(T + i);
  const float lap = __fsub_rn(__fmul_rn(2.0f, __fadd_rn(left, right)),
                              __fmul_rn(8.0f, t));
  const float tk = __fadd_rn(t, 273.15f);
  const float t2 = __fmul_rn(tk, tk);
  const float olr = __fmul_rn(olr_coef, __fmul_rn(t2, t2));
  const float change = __fadd_rn(__fsub_rn(__ldg(asr_row + r), olr),
                                 __fmul_rn(diff_scale, lap));
  out[i] = __fadd_rn(t, __fmul_rn(change, __ldg(cinv + i)));
}

}  // namespace

extern "C" {

// `substeps` substeps from T.  asr: (substeps, H) table; shifts: (2, H)
// int table (kneg row, then kpos row, each mod W).  The result of substep
// s lands in ping (s even) or pong (s odd); the caller reads buffer
// (substeps - 1) % 2.
int demiurge_climate_step(const float* T, const float* cinv,
                          const float* asr, const int* shifts, float* ping,
                          float* pong, int H, int W, int wrap_s, int wrap_n,
                          int pole_shift, int substeps, float diff_scale,
                          float olr_coef, void* stream) {
  const dim3 block(kBlockX);
  const dim3 grid((W + kBlockX - 1) / kBlockX, H);
  for (int s = 0; s < substeps; ++s) {
    const float* src = s == 0 ? T : ((s - 1) & 1 ? pong : ping);
    float* dst = s & 1 ? pong : ping;
    climate_substep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        src, cinv, asr + (long)s * H, shifts, dst, H, W, wrap_s, wrap_n,
        pole_shift, diff_scale, olr_coef);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

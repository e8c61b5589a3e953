// Jacobi sweeps of the ocean's two elliptic solves, for Hopper (sm_90a).
//
// Replaces (demiurge_tpu/pallas_kernels/jacobi.py):
//   - pressure_solve_resident  (:407, _kernel_resident with one field and
//     a b term) — the pressure Poisson solve;
//   - diffusion_solve_resident (:429, _kernel_resident with two fields,
//     no b term, sign flip at the poles) — the implicit viscosity solve;
//   - and with them the banded forms pressure_solve_pallas (:354, _kernel)
//     and diffusion_solve_pallas (:480, _kernel2).  Those exist only
//     because the resident form outgrew the TPU core's VMEM at large
//     grids; this card has no such ceiling, so one kernel serves every
//     grid size.
//
// One launch is one sweep, out of place (ping-pong buffers):
//     f'[r,c] = cN*fN + cS*fS + cE*fE + cW*fW + cC*f (+ b)
// with the neighbours indexed directly by the grid's wrap rules (the
// port's core.topology.shift): x is a ring on a global grid and clamps on a
// regional one; the row beyond a pole is the edge row itself at column
// (c + pole_shift) mod W, times pole_sign (-1 for velocity: a vector
// reverses when the walk crosses a pole); a non-pole edge clamps, and the
// coefficients already fold that weight into cC.  The TPU kernel's pole
// halos with swapped cN/cS, their refresh and the 8-row margins do not
// exist here: Jacobi reads only the previous sweep, so the direct index
// gives the same sweep.
//
// Bound on this card: device-memory bytes.  At 2048x1024 a plane is 8 MB;
// a pressure sweep reads 6 coefficient planes and the field and writes the
// field (about 64 MB), a diffusion sweep reads 5 planes and two fields and
// writes two (about 72 MB) — more than the 50 MB L2, so each sweep streams
// from HBM.  The design keeps the sweep simple and exactly ordered: each
// thread reads its own five taps through the read-only path, and the sum
// is evaluated left to right with explicitly rounded multiplies and adds
// (no FMA contraction), so the result equals the plain PyTorch twin
// (kernels/jacobi.py) bit for bit.  Temporal blocking or an L2-resident
// persistent form would cut the bytes per sweep; they are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int NF, bool HAS_B>
__global__ void jacobi_sweep_kernel(
    const float* __restrict__ cN, const float* __restrict__ cS,
    const float* __restrict__ cE, const float* __restrict__ cW,
    const float* __restrict__ cC, const float* __restrict__ b,
    const float* __restrict__ in0, const float* __restrict__ in1,
    float* __restrict__ out0, float* __restrict__ out1,
    int H, int W, int wrap_x, int wrap_s, int wrap_n, int pole_shift,
    float pole_sign) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (c >= W || r >= H) return;

  int ce = c + 1, cw = c - 1;
  if (wrap_x) {
    if (ce == W) ce = 0;
    if (cw < 0) cw = W - 1;
  } else {
    if (ce == W) ce = W - 1;
    if (cw < 0) cw = 0;
  }
  int rn = r + 1, cn = c;
  float sn = 1.0f;
  if (rn == H) {
    rn = H - 1;
    if (wrap_n) {
      cn = (c + pole_shift) % W;
      sn = pole_sign;
    }
  }
  int rs = r - 1, cs = c;
  float ss = 1.0f;
  if (rs < 0) {
    rs = 0;
    if (wrap_s) {
      cs = (c + pole_shift) % W;
      ss = pole_sign;
    }
  }

  const long i = (long)r * W + c;
  const long iN = (long)rn * W + cn;
  const long iS = (long)rs * W + cs;
  const long iE = (long)r * W + ce;
  const long iW = (long)r * W + cw;
  const float kN = __ldg(cN + i), kS = __ldg(cS + i), kE = __ldg(cE + i),
              kW = __ldg(cW + i), kC = __ldg(cC + i);

#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const float* __restrict__ in = f == 0 ? in0 : in1;
    float* __restrict__ out = f == 0 ? out0 : out1;
    const float fN = __fmul_rn(sn, __ldg(in + iN));
    const float fS = __fmul_rn(ss, __ldg(in + iS));
    float acc = __fadd_rn(__fmul_rn(kN, fN), __fmul_rn(kS, fS));
    acc = __fadd_rn(acc, __fmul_rn(kE, __ldg(in + iE)));
    acc = __fadd_rn(acc, __fmul_rn(kW, __ldg(in + iW)));
    acc = __fadd_rn(acc, __fmul_rn(kC, __ldg(in + i)));
    if constexpr (HAS_B) acc = __fadd_rn(acc, __ldg(b + i));
    out[i] = acc;
  }
}

template <int NF, bool HAS_B>
cudaError_t run_sweeps(const float* cN, const float* cS, const float* cE,
                       const float* cW, const float* cC, const float* b,
                       const float* in0, const float* in1, float* ping0,
                       float* pong0, float* ping1, float* pong1, int H, int W,
                       int wrap_x, int wrap_s, int wrap_n, int pole_shift,
                       float pole_sign, int iters, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  for (int it = 0; it < iters; ++it) {
    // sweep `it` reads the input (it == 0) or the previous sweep's buffer
    const float* src0 = it == 0 ? in0 : ((it - 1) & 1 ? pong0 : ping0);
    const float* src1 = it == 0 ? in1 : ((it - 1) & 1 ? pong1 : ping1);
    float* dst0 = it & 1 ? pong0 : ping0;
    float* dst1 = it & 1 ? pong1 : ping1;
    jacobi_sweep_kernel<NF, HAS_B><<<grid, block, 0, stream>>>(
        cN, cS, cE, cW, cC, b, src0, src1, dst0, dst1, H, W, wrap_x, wrap_s,
        wrap_n, pole_shift, pole_sign);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `iters` sweeps of the pressure solve.  The result of sweep i lands in
// ping (i even) or pong (i odd); the caller reads buffer (iters-1) % 2.
int demiurge_jacobi_pressure(const float* cN, const float* cS,
                             const float* cE, const float* cW,
                             const float* cC, const float* b,
                             const float* p0, float* ping, float* pong,
                             int H, int W, int wrap_x, int wrap_s, int wrap_n,
                             int pole_shift, int iters, void* stream) {
  return (int)run_sweeps<1, true>(cN, cS, cE, cW, cC, b, p0, nullptr, ping,
                                  pong, nullptr, nullptr, H, W, wrap_x, wrap_s,
                                  wrap_n, pole_shift, 1.0f, iters,
                                  (cudaStream_t)stream);
}

// `iters` sweeps of the viscosity solve on (u, v) together, the velocity
// changing sign across a pole.  Result buffers as above.
int demiurge_jacobi_diffusion(const float* cN, const float* cS,
                              const float* cE, const float* cW,
                              const float* cC, const float* u,
                              const float* v, float* u_ping, float* u_pong,
                              float* v_ping, float* v_pong, int H, int W,
                              int wrap_x, int wrap_s, int wrap_n,
                              int pole_shift, int iters, void* stream) {
  return (int)run_sweeps<2, false>(cN, cS, cE, cW, cC, nullptr, u, v, u_ping,
                                   u_pong, v_ping, v_pong, H, W, wrap_x,
                                   wrap_s, wrap_n, pole_shift, -1.0f, iters,
                                   (cudaStream_t)stream);
}

}  // extern "C"

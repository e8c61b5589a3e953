// Jacobi sweeps of the ocean's two solves from one obstacle-bit field and a
// per-row metric table, for Hopper (sm_90a).
//
// Replaces attic/jacobi_packed.py _resident_call_packed (:212,
// _kernel_resident_packed :31), with its inputs _pack_ob (:140) and
// _row_table (:177) ported as kernels/jacobi_packed.py pack_ob and
// row_table.  Instead of K2/K3's five or six float32 coefficient planes a
// sweep reads one int32 a pixel (bit 0 N solid, 1 S solid, 2 E solid, 3 W
// solid: the blocked neighbour is replaced by the centre; bit 4 land) and
// (cx, cy, c0) of its row:
//     f'[r,c] = cx*(fE + fW) + cy*(fN + fS) + (b  or  c0*f)
// in the reference's form (:88-92), zero on land when `sea_mask` is set.
// One launch is one sweep, out of place (ping-pong buffers), as K2.  The
// TPU kernel's k-row pole halos, with the N/S bits swapped in them, their
// refresh every k sweeps and its even-iters rule exist for VMEM; here the
// neighbour across a pole is indexed directly (row H-1 or 0 at column
// c + pole_shift, times -1 for velocities), and the N/S meaning of the bits
// needs no swap because the cell's own bits are read, never a halo's.
// Every operation is rounded as the plain twin rounds it (__fmul_rn and
// __fadd_rn, no contraction), so the result equals the twin's bit for bit.
//
// Bound on this card: float32 operations over the sweeps, or bytes: the
// function must read ob, the row table, b and the field and write the
// field once (16 bytes a pixel).  Per sweep it reads 3 planes (ob, b, the
// field) and writes one, about 33.5 MB at 2048x1024, against K2's 64 MB:
// that fits the 50 MB L2, which is what this design tests on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int NF, bool HAS_B>
__global__ void jacobi_packed_kernel(
    const int* __restrict__ ob, const float* __restrict__ rowtab,
    const float* __restrict__ b, const float* __restrict__ in0,
    const float* __restrict__ in1, float* __restrict__ out0,
    float* __restrict__ out1, int H, int W, int wrap_x, int wrap_s,
    int wrap_n, int pole_shift, float pole_sign, int sea_mask) {
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
  const int o = __ldg(ob + i);
  const float cx = __ldg(rowtab + 3 * r), cy = __ldg(rowtab + 3 * r + 1),
              c0 = __ldg(rowtab + 3 * r + 2);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const float* __restrict__ in = f == 0 ? in0 : in1;
    float* __restrict__ out = f == 0 ? out0 : out1;
    const float p = __ldg(in + i);
    const float pN = (o & 1) ? p : __fmul_rn(sn, __ldg(in + (long)rn * W + cn));
    const float pS = (o & 2) ? p : __fmul_rn(ss, __ldg(in + (long)rs * W + cs));
    const float pE = (o & 4) ? p : __ldg(in + (long)r * W + ce);
    const float pW = (o & 8) ? p : __ldg(in + (long)r * W + cw);
    float acc = __fadd_rn(__fmul_rn(cx, __fadd_rn(pE, pW)),
                          __fmul_rn(cy, __fadd_rn(pN, pS)));
    if constexpr (HAS_B)
      acc = __fadd_rn(acc, __ldg(b + i));
    else
      acc = __fadd_rn(acc, __fmul_rn(c0, p));
    if (sea_mask && (o & 16)) acc = 0.0f;
    out[i] = acc;
  }
}

template <int NF, bool HAS_B>
cudaError_t run_sweeps(const int* ob, const float* rowtab, const float* b,
                       const float* in0, const float* in1, float* ping0,
                       float* pong0, float* ping1, float* pong1, int H, int W,
                       int wrap_x, int wrap_s, int wrap_n, int pole_shift,
                       float pole_sign, int sea_mask, int iters,
                       cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  for (int it = 0; it < iters; ++it) {
    const float* src0 = it == 0 ? in0 : ((it - 1) & 1 ? pong0 : ping0);
    const float* src1 = it == 0 ? in1 : ((it - 1) & 1 ? pong1 : ping1);
    jacobi_packed_kernel<NF, HAS_B><<<grid, block, 0, stream>>>(
        ob, rowtab, b, src0, src1, it & 1 ? pong0 : ping0,
        it & 1 ? pong1 : ping1, H, W, wrap_x, wrap_s, wrap_n, pole_shift,
        pole_sign, sea_mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `iters` sweeps on one field (in1 null) or two.  b null: the c0*f form.
// The result of sweep i lands in ping (i even) or pong (i odd); the caller
// reads buffer (iters-1) % 2.  negate: the field changes sign across a pole.
int demiurge_jacobi_packed(const int* ob, const float* rowtab, const float* b,
                           const float* in0, const float* in1, float* ping0,
                           float* pong0, float* ping1, float* pong1, int H,
                           int W, int wrap_x, int wrap_s, int wrap_n,
                           int pole_shift, int sea_mask, int negate,
                           int iters, void* stream) {
  const float sign = negate ? -1.0f : 1.0f;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool two = in1 != nullptr;
  if (b != nullptr && !two)
    return (int)run_sweeps<1, true>(ob, rowtab, b, in0, in0, ping0, pong0,
                                    ping0, pong0, H, W, wrap_x, wrap_s, wrap_n,
                                    pole_shift, sign, sea_mask, iters, st);
  if (b == nullptr && !two)
    return (int)run_sweeps<1, false>(ob, rowtab, b, in0, in0, ping0, pong0,
                                     ping0, pong0, H, W, wrap_x, wrap_s,
                                     wrap_n, pole_shift, sign, sea_mask, iters,
                                     st);
  if (b != nullptr)
    return (int)run_sweeps<2, true>(ob, rowtab, b, in0, in1, ping0, pong0,
                                    ping1, pong1, H, W, wrap_x, wrap_s, wrap_n,
                                    pole_shift, sign, sea_mask, iters, st);
  return (int)run_sweeps<2, false>(ob, rowtab, b, in0, in1, ping0, pong0,
                                   ping1, pong1, H, W, wrap_x, wrap_s, wrap_n,
                                   pole_shift, sign, sea_mask, iters, st);
}

}  // extern "C"

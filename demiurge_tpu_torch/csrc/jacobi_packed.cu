// Jacobi sweeps of the ocean's two solves from one obstacle-bit field and a
// per-row metric table, for Hopper (sm_90a).
//
// Replaces attic/jacobi_packed.py _resident_call_packed (:212,
// _kernel_resident_packed :31), with its inputs _pack_ob (:140) and
// _row_table (:177) ported as kernels/jacobi_packed.py pack_ob and
// row_table.  Instead of K2/K3's five float32 coefficient planes a sweep
// reads one int32 a pixel (bit 0 N solid, 1 S solid, 2 E solid, 3 W solid:
// the blocked neighbour is replaced by the centre; bit 4 land) and (cx, cy,
// c0) of its row:
//     f'[r,c] = cx*(fE + fW) + cy*(fN + fS) + (b  or  c0*f)
// in the reference's form (:88-92), zero on land when `sea_mask` is set,
// the neighbour across a pole times -1 for velocities.  Every operation is
// rounded as the plain twin rounds it (__fmul_rn and __fadd_rn, no
// contraction), so the result equals the twin's bit for bit.
//
// Design: K2's temporal blocking (csrc/jacobi.cu, whose header gives the
// schedule and the argument in full).  One launch runs k = kSweeps sweeps
// (the last launch of a solve the remainder): a block owns a TH x TW output
// tile, loads the tile and a k-cell halo once, the field(s) and b into
// shared memory by cp.async and each extended cell's five bits into a
// shared byte, with the row table of each extended row in shared memory;
// it sweeps the region k times between two shared buffers and writes back
// its own cells.  The rows of the extended region
// are read in K2's unfolded frame: after n pole crossings a row stands for
// grid row q or H-1-q at column c + n * pole_shift, its field and b times
// pole_sign^n and, n odd, its bits 0 and 1 swapped, as K2 swaps cN and cS
// (the extended north is then the grid's south, and fN + fS commutes
// exactly); clamped edges take a step of 0, and the way back across a pole
// lands delta = 2 * pole_shift - W columns over.
// tests/test_torch_jacobi_packed_tiles.py runs this schedule in numpy
// against the twin.
//
// Why this design on this card.  K2's threads hold five floats of every
// cell they own (75 registers of coefficients), so K2 runs one block an
// SM, and its loads and its sweeps take turns.  Here a cell's coefficients
// are one byte of shared memory, so the registers (48, no spill) and the
// shared memory (90 KB a pressure block at 32 x 128, k = 8) are budgeted
// for kBlocksPerSM = 2 blocks an SM.  A launch reads 12 bytes an extended
// cell (the field, b and the bits) against K2's 28.  PERF.md has the
// shapes raced: the bits in registers spilled at two blocks an SM (1.5x
// slower), and in shared memory one block an SM and two time the same.
//
// Bound on this card: float32 operations, 6 a cell a sweep (two adds in
// the brackets, two products, their sum, the b term; 7 with c0*f), or
// bytes: the bits, the row table, b and the field read once and the field
// written once (16 bytes a pixel).
//
// demiurge_jacobi_packed_sweeps is the earlier design (one launch a sweep,
// one thread a pixel, the pole neighbour indexed directly), kept callable
// as the yardstick the smoke times beside this one.

#include <cuda_runtime.h>

namespace {

// sweeps a launch and the output tiles (rows x columns) of the one-field
// (pressure) and two-field (viscosity) forms; PERF.md has the shapes raced
constexpr int kSweeps = 8;
constexpr int kPressureRows = 32, kPressureCols = 128;
constexpr int kDiffusionRows = 32, kDiffusionCols = 64;

// a block's threads, and the blocks an SM its registers are budgeted for
constexpr int kThreadsX = 32, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kBlocksPerSM = 2;

template <int NF, bool HAS_B, int TH, int TW>
constexpr size_t tile_smem() {
  // b and two buffers a field, each with a spare float before and after
  // it, then a byte of bits a cell
  return sizeof(float) * ((HAS_B ? 1 : 0) + 2 * NF) *
         ((TH + 2 * kSweeps) * (TW + 2 * kSweeps) + 2) +
         (TH + 2 * kSweeps) * (TW + 2 * kSweeps);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <int NF, bool HAS_B, int TH, int TW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    packed_tile_kernel(const int* __restrict__ ob,
                       const float* __restrict__ rowtab,
                       const float* __restrict__ b,
                       const float* __restrict__ in0,
                       const float* __restrict__ in1,
                       float* __restrict__ out0, float* __restrict__ out1,
                       int H, int W, int wrap_x, int wrap_s, int wrap_n,
                       int pole_shift, float pole_sign, int sea_mask,
                       int sweeps) {
  constexpr int K = kSweeps;
  constexpr int EH = TH + 2 * K, EW = TW + 2 * K, EN = EH * EW;
  constexpr int EP = EN + 2;    // a buffer and its two spare floats
  // thread (tx, ty) loads and sweeps the extended cells (ty + kThreadsY j,
  // tx + kThreadsX i)
  constexpr int JR = (EH + kThreadsY - 1) / kThreadsY;
  constexpr int IC = (EW + kThreadsX - 1) / kThreadsX;
  extern __shared__ float smem[];
  float* const tB = smem + 1;                     // HAS_B only
  float* const fbuf = tB + (HAS_B ? EP : 0);      // field f, buffer q:
                                                  // fbuf + (2 f + q) EP
  unsigned char* const sO =                       // the bits, a byte a cell
      reinterpret_cast<unsigned char*>(fbuf + 2 * NF * EP - 1);
  __shared__ long s_base[EH];   // grid row * W
  __shared__ int s_off[EH];     // column offset
  __shared__ float s_sgn[EH];   // pole_sign^n
  __shared__ int s_swap[EH];    // n odd: bits 0 and 1 swapped
  __shared__ int s_nstep[EH], s_sstep[EH];
  __shared__ float s_cx[EH], s_cy[EH], s_c0[EH];

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int delta = 2 * pole_shift - W;

  // the extended rows: grid row, frame, neighbour steps and row table
  for (int ly = tid; ly < EH; ly += kThreads) {
    const int e = r0 - K + ly;
    const int m = floordiv(e, H);
    const int q = e - m * H;
    const int n = m < 0 ? -m : m;   // pole crossings from the grid
    const bool odd = n & 1;
    const int g = odd ? H - 1 - q : q;
    s_base[ly] = (long)g * W;
    s_off[ly] = (int)(((long)n * pole_shift) % W);
    s_sgn[ly] = odd ? pole_sign : 1.0f;
    s_swap[ly] = odd;
    int ns = EW, ss = -EW;
    if (q == H - 1) {               // a pole between e and e + 1
      const int up = m + 1;
      const bool wraps = (up & 1) ? wrap_n : wrap_s;
      ns = wraps ? EW + (up <= 0 ? delta : 0) : 0;
    }
    if (q == 0) {                   // a pole between e - 1 and e
      const bool wraps = (m & 1) ? wrap_n : wrap_s;
      ss = wraps ? -EW + (m >= 1 ? delta : 0) : 0;
    }
    s_nstep[ly] = ns;
    s_sstep[ly] = ss;
    s_cx[ly] = __ldg(rowtab + 3 * g);
    s_cy[ly] = __ldg(rowtab + 3 * g + 1);
    s_c0[ly] = __ldg(rowtab + 3 * g + 2);
  }
  __syncthreads();

  // load the extended region: the bits, b and the field(s) into shared
  // memory
#pragma unroll
  for (int j = 0; j < JR; ++j) {
    const int ly = threadIdx.y + kThreadsY * j;
#pragma unroll
    for (int i = 0; i < IC; ++i) {
      const int lx = threadIdx.x + kThreadsX * i;
      if (ly >= EH || lx >= EW) continue;
      const int x = c0 - K + lx;
      int col;
      if (wrap_x) {
        col = (x + s_off[ly]) % W;
        if (col < 0) col += W;
      } else {
        col = x < 0 ? 0 : (x >= W ? W - 1 : x);
      }
      const long gi = s_base[ly] + col;
      const int idx = ly * EW + lx;
      if constexpr (HAS_B) copy_async(tB + idx, b + gi);
      copy_async(fbuf + idx, in0 + gi);
      if constexpr (NF == 2) copy_async(fbuf + 2 * EP + idx, in1 + gi);
      const int o = __ldg(ob + gi);
      const int bits = s_swap[ly] ? (o & 28) | ((o & 1) << 1) | ((o >> 1) & 1)
                                  : o & 31;
      sO[idx] = (unsigned char)bits;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // the rows past an odd number of poles hold the field (and b) times
  // pole_sign
  if (pole_sign != 1.0f) {
    for (int ly = threadIdx.y; ly < EH; ly += kThreadsY) {
      const float sg = s_sgn[ly];
      if (sg == 1.0f) continue;
      for (int lx = threadIdx.x; lx < EW; lx += kThreadsX) {
        const int idx = ly * EW + lx;
        if constexpr (HAS_B) tB[idx] = __fmul_rn(sg, tB[idx]);
        fbuf[idx] = __fmul_rn(sg, fbuf[idx]);
        if constexpr (NF == 2)
          fbuf[2 * EP + idx] = __fmul_rn(sg, fbuf[2 * EP + idx]);
      }
    }
    __syncthreads();
  }

  // the sweeps, between buffers 0 and 1 of each field, as K2's: sweep t
  // computes every column of the rows inset by k - s + t.  The row steps
  // come from shared memory (one value a warp); the columns whose east or
  // west step is 0 (past a clamped edge) are bits of two masks.
  unsigned east0 = 0, west0 = 0;
#pragma unroll
  for (int i = 0; i < IC; ++i) {
    const int x = c0 - K + threadIdx.x + kThreadsX * i;
    if (!wrap_x && x >= W - 1) east0 |= 1u << i;
    if (!wrap_x && x <= 0) west0 |= 1u << i;
  }
  for (int t = 1; t <= sweeps; ++t) {
    const int lo = K - sweeps + t;
    const int from = ((t - 1) & 1) * EP, to = (t & 1) * EP;
#pragma unroll
    for (int j = 0; j < JR; ++j) {
      const int ly = threadIdx.y + kThreadsY * j;
      if (ly < lo || ly >= EH - lo) continue;
      const float cx = s_cx[ly], cy = s_cy[ly], cc = s_c0[ly];
      const int ns = s_nstep[ly], ss = s_sstep[ly];
#pragma unroll
      for (int i = 0; i < IC; ++i) {
        const int lx = threadIdx.x + kThreadsX * i;
        if (IC * kThreadsX > EW && lx >= EW) continue;
        const int c = ly * EW + lx;
        const unsigned o = sO[c];
        const int es = (east0 >> i) & 1 ? 0 : 1;
        const int ws = (west0 >> i) & 1 ? 0 : -1;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float* a = fbuf + 2 * f * EP + from;
          const float p = a[c];
          const float pN = (o & 1) ? p : a[c + ns];
          const float pS = (o & 2) ? p : a[c + ss];
          const float pE = (o & 4) ? p : a[c + es];
          const float pW = (o & 8) ? p : a[c + ws];
          float acc = __fadd_rn(__fmul_rn(cx, __fadd_rn(pE, pW)),
                                __fmul_rn(cy, __fadd_rn(pN, pS)));
          if constexpr (HAS_B)
            acc = __fadd_rn(acc, tB[c]);
          else
            acc = __fadd_rn(acc, __fmul_rn(cc, p));
          if (sea_mask && (o & 16)) acc = 0.0f;
          fbuf[2 * f * EP + to + c] = acc;
        }
      }
    }
    __syncthreads();
  }

  // write back the tile's own cells
  const int res = (sweeps & 1) * EP;
  for (int idx = tid; idx < TH * TW; idx += kThreads) {
    const int ry = idx / TW, rx = idx - ry * TW;
    const int r = r0 + ry, c = c0 + rx;
    if (r >= H || c >= W) continue;
    const int i = (ry + K) * EW + rx + K;
    const long o = (long)r * W + c;
    out0[o] = fbuf[res + i];
    if constexpr (NF == 2) out1[o] = fbuf[2 * EP + res + i];
  }
}

// ceil(iters / k) launches; launch j reads the input (j == 0) or the
// previous launch's buffer and writes ping (j even) or pong (j odd).
template <int NF, bool HAS_B, int TH, int TW>
cudaError_t run_tiles(const int* ob, const float* rowtab, const float* b,
                      const float* in0, const float* in1, float* ping0,
                      float* pong0, float* ping1, float* pong1, int H, int W,
                      int wrap_x, int wrap_s, int wrap_n, int pole_shift,
                      float pole_sign, int sea_mask, int iters,
                      cudaStream_t stream) {
  const auto kernel = packed_tile_kernel<NF, HAS_B, TH, TW>;
  constexpr size_t smem = tile_smem<NF, HAS_B, TH, TW>();
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  const int n = (iters + kSweeps - 1) / kSweeps;
  for (int j = 0; j < n; ++j) {
    const int sweeps = iters - j * kSweeps < kSweeps ? iters - j * kSweeps
                                                     : kSweeps;
    const float* src0 = j == 0 ? in0 : ((j - 1) & 1 ? pong0 : ping0);
    const float* src1 = j == 0 ? in1 : ((j - 1) & 1 ? pong1 : ping1);
    kernel<<<grid, block, smem, stream>>>(
        ob, rowtab, b, src0, src1, j & 1 ? pong0 : ping0,
        j & 1 ? pong1 : ping1, H, W, wrap_x, wrap_s, wrap_n, pole_shift,
        pole_sign, sea_mask, sweeps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The earlier design, the yardstick: one launch a sweep, one thread a
// pixel, the neighbour across a pole indexed directly (row H-1 or 0 at
// column c + pole_shift, times pole_sign); the cell's own bits are read,
// so no swap is needed.
// ---------------------------------------------------------------------------

constexpr int kSweepBlockX = 32;
constexpr int kSweepBlockY = 8;

template <int NF, bool HAS_B>
__global__ void packed_sweep_kernel(
    const int* __restrict__ ob, const float* __restrict__ rowtab,
    const float* __restrict__ b, const float* __restrict__ in0,
    const float* __restrict__ in1, float* __restrict__ out0,
    float* __restrict__ out1, int H, int W, int wrap_x, int wrap_s,
    int wrap_n, int pole_shift, float pole_sign, int sea_mask) {
  const int c = blockIdx.x * kSweepBlockX + threadIdx.x;
  const int r = blockIdx.y * kSweepBlockY + threadIdx.y;
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
  const dim3 block(kSweepBlockX, kSweepBlockY);
  const dim3 grid((W + kSweepBlockX - 1) / kSweepBlockX,
                  (H + kSweepBlockY - 1) / kSweepBlockY);
  for (int it = 0; it < iters; ++it) {
    const float* src0 = it == 0 ? in0 : ((it - 1) & 1 ? pong0 : ping0);
    const float* src1 = it == 0 ? in1 : ((it - 1) & 1 ? pong1 : ping1);
    packed_sweep_kernel<NF, HAS_B><<<grid, block, 0, stream>>>(
        ob, rowtab, b, src0, src1, it & 1 ? pong0 : ping0,
        it & 1 ? pong1 : ping1, H, W, wrap_x, wrap_s, wrap_n, pole_shift,
        pole_sign, sea_mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The built shape, and a pole shift whose two crossings land within a
// column of the start (round(W / 2), as core.topology gives it).
bool accepted(int th, int tw, int k, int TH, int TW, int W, int pole_shift) {
  const int delta = 2 * pole_shift - W;
  return th == TH && tw == TW && k == kSweeps && delta >= -1 && delta <= 1;
}

}  // namespace

extern "C" {

// `iters` sweeps on one field (in1 null; the pressure tile) or two (the
// viscosity tile), in ceil(iters / k) launches.  b null: the c0*f form.
// negate: the field changes sign across a pole.  The result of launch j
// lands in ping (j even) or pong (j odd); the caller reads buffer
// (launches - 1) % 2.  (th, tw, k) must be the built tile and sweeps a
// launch of that many fields, else cudaErrorInvalidValue.
int demiurge_jacobi_packed(const int* ob, const float* rowtab, const float* b,
                           const float* in0, const float* in1, float* ping0,
                           float* pong0, float* ping1, float* pong1, int H,
                           int W, int wrap_x, int wrap_s, int wrap_n,
                           int pole_shift, int sea_mask, int negate, int th,
                           int tw, int k, int iters, void* stream) {
  const float sign = negate ? -1.0f : 1.0f;
  const cudaStream_t st = (cudaStream_t)stream;
  if (in1 == nullptr) {
    if (!accepted(th, tw, k, kPressureRows, kPressureCols, W, pole_shift))
      return (int)cudaErrorInvalidValue;
    if (b != nullptr)
      return (int)run_tiles<1, true, kPressureRows, kPressureCols>(
          ob, rowtab, b, in0, nullptr, ping0, pong0, nullptr, nullptr, H, W,
          wrap_x, wrap_s, wrap_n, pole_shift, sign, sea_mask, iters, st);
    return (int)run_tiles<1, false, kPressureRows, kPressureCols>(
        ob, rowtab, b, in0, nullptr, ping0, pong0, nullptr, nullptr, H, W,
        wrap_x, wrap_s, wrap_n, pole_shift, sign, sea_mask, iters, st);
  }
  if (!accepted(th, tw, k, kDiffusionRows, kDiffusionCols, W, pole_shift))
    return (int)cudaErrorInvalidValue;
  if (b != nullptr)
    return (int)run_tiles<2, true, kDiffusionRows, kDiffusionCols>(
        ob, rowtab, b, in0, in1, ping0, pong0, ping1, pong1, H, W, wrap_x,
        wrap_s, wrap_n, pole_shift, sign, sea_mask, iters, st);
  return (int)run_tiles<2, false, kDiffusionRows, kDiffusionCols>(
      ob, rowtab, b, in0, in1, ping0, pong0, ping1, pong1, H, W, wrap_x,
      wrap_s, wrap_n, pole_shift, sign, sea_mask, iters, st);
}

// The earlier design (the yardstick): `iters` sweeps, one launch a sweep;
// the result of sweep i lands in ping (i even) or pong (i odd).
int demiurge_jacobi_packed_sweeps(const int* ob, const float* rowtab,
                                  const float* b, const float* in0,
                                  const float* in1, float* ping0,
                                  float* pong0, float* ping1, float* pong1,
                                  int H, int W, int wrap_x, int wrap_s,
                                  int wrap_n, int pole_shift, int sea_mask,
                                  int negate, int iters, void* stream) {
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

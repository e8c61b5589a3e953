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
//     grids; here one tiled kernel serves every grid size.
//
// A sweep, out of place:
//     f'[r,c] = cN*fN + cS*fS + cE*fE + cW*fW + cC*f (+ b)
// with the neighbours of the grid's wrap rules (the port's
// core.topology.shift): x is a ring on a global grid and clamps on a
// regional one; the row beyond a pole is the edge row itself at column
// (c + pole_shift) mod W, times pole_sign (-1 for velocity); a non-pole
// edge clamps (the neighbour is the cell itself).  Each sum is taken left
// to right with explicitly rounded multiplies and adds (no FMA
// contraction), as the plain PyTorch twin (kernels/jacobi.py) takes it, so
// the result equals the twin bit for bit.
//
// Bound on this card.  At 2048x1024 a plane is 8 MB; the least work reads
// the coefficient planes and the field once and writes the field once
// (8 planes for pressure, 9 for viscosity: 0.020 and 0.022 ms at 3.35
// TB/s), but 9 operations a cell a sweep over 200 (50 on two fields)
// sweeps bound it by operations (0.056 and 0.028 ms at 67 TFLOP/s).  One
// launch a sweep streamed every plane from device memory each sweep (64
// MB a pressure sweep, 72 MB a viscosity sweep, more than the 50 MB L2):
// 25.1 us a sweep, at the per-sweep memory floor, 5.1 ms for 200.
//
// Design: temporal blocking.  One launch runs k = kSweeps sweeps.  A block
// owns an output tile of TH x TW cells and loads the tile plus a halo of k
// cells on every side once: the field(s) and b into shared memory by
// cp.async, the five coefficients into registers, each thread keeping
// those of the extended cells it owns for the whole launch.  It then
// sweeps the region k times between two shared buffers and writes back
// its TH x TW cells, so a solve reads each plane ceil(iters / k) times,
// times the halo's overlap (1.69 for a 32 x 128 tile at k = 8), instead
// of iters times.  Sweep t computes every column of the rows still right,
// those inset by t (k - s + t in the last launch of a solve, which runs
// the remainder s < k): a row test is uniform across a warp, and the
// columns past the region are computed and never read, so a thread's
// cells of a row are one run of independent sums.  What is left: the
// loads (99 MB a pressure launch, near the memory rate) and the sweeps
// (latency-bound at 16 warps an SM) take turns on each SM, one block an
// SM; PERF.md has the shapes, warps and k raced.
//
// The topology inside the extended region.  Row ly of a tile whose first
// row is r0 stands for the unfolded grid row e = r0 - k + ly: rows past a
// pole are the rows on the far side of it, pole after pole (row H + j is
// row H-1-j, row 2H + j is row j, ...; likewise below 0).  After n pole
// crossings a row is read at column c + n * pole_shift, its field and b
// times pole_sign^n, and, n odd, with cN and cS swapped: in that frame the
// extended north is the grid's south.  Those rows then evolve exactly as
// the cells they stand for (the TPU kernel's pole halos, _pad_coeff): the
// first two products of the sum change places, which is exact since
// addition commutes, and a negation distributes exactly over
// round-to-nearest (up to the sign of a zero, which compares equal).  An
// extended cell's neighbour is the cell beside it, with two exceptions
// kept in per-row and per-column steps: across a clamped edge the step is
// 0 (the cell itself), so rows and columns past a clamped edge hold
// arbitrary cells no valid cell reads; and on the way back across a pole
// (toward the grid) the step lands delta = 2 * pole_shift - W columns over,
// since two crossings move the column by 2 * pole_shift, which is W + 1 or
// W - 1 for odd W.  A step moves at most one row and one column, so after
// t sweeps every cell t cells inside the extended rectangle is right,
// whatever the cells nearer its edge hold, and the output tile is right
// after k sweeps whatever the grid's size: the dateline wraps the halo
// onto the tile's own columns when W < TW + 2k, and the rows reach across
// both poles when H < 2k.
// tests/test_torch_jacobi_tiles.py runs this schedule in numpy against the
// twins.

#include <cuda_runtime.h>

namespace {

// sweeps a launch and the output tiles (rows x columns); PERF.md has the
// shapes raced
constexpr int kSweeps = 8;
constexpr int kPressureRows = 32, kPressureCols = 128;
constexpr int kDiffusionRows = 32, kDiffusionCols = 64;

// a block's threads, and the blocks an SM its registers are budgeted for
constexpr int kThreadsX = 32, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kBlocksPerSM = 1;

template <int NF, bool HAS_B, int TH, int TW>
constexpr size_t tile_smem() {
  // b and two buffers a field, each with a spare float before and after
  // it; the coefficients live in registers
  return sizeof(float) * ((HAS_B ? 1 : 0) + 2 * NF) *
         ((TH + 2 * kSweeps) * (TW + 2 * kSweeps) + 2);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// one float from device memory to shared memory, asynchronously (Ampere's
// cp.async): a block's loads all go in flight before it waits once
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <int NF, bool HAS_B, int TH, int TW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    jacobi_tile_kernel(const float* __restrict__ cN,
                       const float* __restrict__ cS,
                       const float* __restrict__ cE,
                       const float* __restrict__ cW,
                       const float* __restrict__ cC,
                       const float* __restrict__ b,
                       const float* __restrict__ in0,
                       const float* __restrict__ in1,
                       float* __restrict__ out0, float* __restrict__ out1,
                       int H, int W, int wrap_x, int wrap_s, int wrap_n,
                       int pole_shift, float pole_sign, int sweeps) {
  constexpr int K = kSweeps;
  constexpr int EH = TH + 2 * K, EW = TW + 2 * K, EN = EH * EW;
  constexpr int EP = EN + 2;    // a buffer and its two spare floats
  // thread (tx, ty) owns the extended cells (ty + kThreadsY j, tx +
  // kThreadsX i) for the whole launch and keeps their coefficients in
  // registers
  constexpr int JR = (EH + kThreadsY - 1) / kThreadsY;
  constexpr int IC = (EW + kThreadsX - 1) / kThreadsX;
  extern __shared__ float smem[];
  float* const tB = smem + 1;                     // HAS_B only
  float* const fbuf = tB + (HAS_B ? EP : 0);      // field f, buffer q:
                                                  // fbuf + (2 f + q) EP
  __shared__ long s_base[EH];   // grid row * W
  __shared__ int s_off[EH];     // column offset
  __shared__ float s_sgn[EH];   // pole_sign^n
  __shared__ int s_swap[EH];    // n odd: cN and cS swapped
  __shared__ int s_nstep[EH], s_sstep[EH];

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int delta = 2 * pole_shift - W;

  // the extended rows: grid row, frame and neighbour steps
  for (int ly = tid; ly < EH; ly += kThreads) {
    const int e = r0 - K + ly;
    const int m = floordiv(e, H);
    const int q = e - m * H;
    const int n = m < 0 ? -m : m;   // pole crossings from the grid
    const bool odd = n & 1;
    s_base[ly] = (long)(odd ? H - 1 - q : q) * W;
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
  }
  __syncthreads();

  // load the extended region: the coefficients into registers, b and the
  // field(s) into shared memory
  float kN[JR][IC], kS[JR][IC], kE[JR][IC], kW[JR][IC], kC[JR][IC];
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
      const bool sw = s_swap[ly];
      const int idx = ly * EW + lx;
      if constexpr (HAS_B) copy_async(tB + idx, b + gi);
      copy_async(fbuf + idx, in0 + gi);
      if constexpr (NF == 2) copy_async(fbuf + 2 * EP + idx, in1 + gi);
      kN[j][i] = __ldg((sw ? cS : cN) + gi);
      kS[j][i] = __ldg((sw ? cN : cS) + gi);
      kE[j][i] = __ldg(cE + gi);
      kW[j][i] = __ldg(cW + gi);
      kC[j][i] = __ldg(cC + gi);
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

  // the sweeps, between buffers 0 and 1 of each field.  Sweep t computes
  // every column of the rows still right (inset by k - s + t): the row
  // test is uniform across a warp, and the columns past the region are
  // computed and never read, so a thread's cells of a row form one
  // straight run of independent sums.  The edge columns' steps stay within
  // the spare floats.
  int ns[JR], ss[JR], es[IC], ws[IC];
#pragma unroll
  for (int j = 0; j < JR; ++j) {
    const int ly = threadIdx.y + kThreadsY * j;
    ns[j] = ly < EH ? s_nstep[ly] : 0;
    ss[j] = ly < EH ? s_sstep[ly] : 0;
  }
#pragma unroll
  for (int i = 0; i < IC; ++i) {
    const int x = c0 - K + threadIdx.x + kThreadsX * i;
    es[i] = (wrap_x || x < W - 1) ? 1 : 0;
    ws[i] = (wrap_x || x > 0) ? -1 : 0;
  }
  for (int t = 1; t <= sweeps; ++t) {
    const int lo = K - sweeps + t;
    const int from = ((t - 1) & 1) * EP, to = (t & 1) * EP;
#pragma unroll
    for (int j = 0; j < JR; ++j) {
      const int ly = threadIdx.y + kThreadsY * j;
      if (ly < lo || ly >= EH - lo) continue;
#pragma unroll
      for (int i = 0; i < IC; ++i) {
        const int lx = threadIdx.x + kThreadsX * i;
        if (IC * kThreadsX > EW && lx >= EW) continue;
        const int c = ly * EW + lx;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float* a = fbuf + 2 * f * EP + from;
          float acc = __fadd_rn(__fmul_rn(kN[j][i], a[c + ns[j]]),
                                __fmul_rn(kS[j][i], a[c + ss[j]]));
          acc = __fadd_rn(acc, __fmul_rn(kE[j][i], a[c + es[i]]));
          acc = __fadd_rn(acc, __fmul_rn(kW[j][i], a[c + ws[i]]));
          acc = __fadd_rn(acc, __fmul_rn(kC[j][i], a[c]));
          if constexpr (HAS_B) acc = __fadd_rn(acc, tB[c]);
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
cudaError_t run_tiles(const float* cN, const float* cS, const float* cE,
                      const float* cW, const float* cC, const float* b,
                      const float* in0, const float* in1, float* ping0,
                      float* pong0, float* ping1, float* pong1, int H, int W,
                      int wrap_x, int wrap_s, int wrap_n, int pole_shift,
                      float pole_sign, int iters, cudaStream_t stream) {
  const auto kernel = jacobi_tile_kernel<NF, HAS_B, TH, TW>;
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
    float* dst0 = j & 1 ? pong0 : ping0;
    float* dst1 = j & 1 ? pong1 : ping1;
    kernel<<<grid, block, smem, stream>>>(cN, cS, cE, cW, cC, b, src0, src1,
                                          dst0, dst1, H, W, wrap_x, wrap_s,
                                          wrap_n, pole_shift, pole_sign,
                                          sweeps);
    err = cudaGetLastError();
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

// `iters` sweeps of the pressure solve in ceil(iters / k) launches.  The
// result of launch j lands in ping (j even) or pong (j odd); the caller
// reads buffer (launches - 1) % 2.  (th, tw, k) must be the built tile
// and sweeps a launch, else cudaErrorInvalidValue.
int demiurge_jacobi_pressure(const float* cN, const float* cS,
                             const float* cE, const float* cW,
                             const float* cC, const float* b,
                             const float* p0, float* ping, float* pong,
                             int H, int W, int wrap_x, int wrap_s, int wrap_n,
                             int pole_shift, int th, int tw, int k, int iters,
                             void* stream) {
  if (!accepted(th, tw, k, kPressureRows, kPressureCols, W, pole_shift))
    return (int)cudaErrorInvalidValue;
  return (int)run_tiles<1, true, kPressureRows, kPressureCols>(
      cN, cS, cE, cW, cC, b, p0, nullptr, ping, pong, nullptr, nullptr, H, W,
      wrap_x, wrap_s, wrap_n, pole_shift, 1.0f, iters, (cudaStream_t)stream);
}

// `iters` sweeps of the viscosity solve on (u, v) together, the velocity
// changing sign across a pole.  Result buffers and refusal as above.
int demiurge_jacobi_diffusion(const float* cN, const float* cS,
                              const float* cE, const float* cW,
                              const float* cC, const float* u,
                              const float* v, float* u_ping, float* u_pong,
                              float* v_ping, float* v_pong, int H, int W,
                              int wrap_x, int wrap_s, int wrap_n,
                              int pole_shift, int th, int tw, int k,
                              int iters, void* stream) {
  if (!accepted(th, tw, k, kDiffusionRows, kDiffusionCols, W, pole_shift))
    return (int)cudaErrorInvalidValue;
  return (int)run_tiles<2, false, kDiffusionRows, kDiffusionCols>(
      cN, cS, cE, cW, cC, nullptr, u, v, u_ping, u_pong, v_ping, v_pong, H,
      W, wrap_x, wrap_s, wrap_n, pole_shift, -1.0f, iters,
      (cudaStream_t)stream);
}

}  // extern "C"

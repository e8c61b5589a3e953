// Substeps of the climate model's energy balance, for Hopper (sm_90a).
//
// Replaces demiurge_tpu/pallas_kernels/climate.py: climate_step_pallas
// (:132, _kernel :90, with _row_shifts :70 and the pole halos of
// _pad_rows_reflect :58).
//
// A substep, out of place:
//     S(c)  = T[north][c] + T[south][c]
//     lap   = 2 * (S(c + kneg_r) + S(c + kpos_r)) - 8 * T
//     Tk    = T + 273.15;  olr = olr_coef * ((Tk * Tk) * (Tk * Tk))
//     T'    = T + ((asr[s][r] - olr) + D * lap) * cinv
// — the corner-tap sum of the TPU kernel (the straight taps of the
// spherical Laplacian cancel in lx + ly).  kneg/kpos are the per-row
// NEAREST column shifts of the 1/cos(phi)-stretched corner taps, a (2, H)
// table built once per grid; north and south follow core.topology.shift
// (beyond a pole the edge row itself at column c + pole_shift, elsewhere
// the grid clamps); asr is the (K, H) insolation table of the K substeps,
// built on the device by the caller.  Each sum is evaluated in the plain
// twin's order with explicitly rounded operations (no FMA contraction), so
// the result equals kernels/climate.py's climate_step_plain bit for bit.
//
// Bound on this card: device-memory bytes.  A call reads T and cinv and
// writes T once (25 MB at 2048x1024) against about 14 flops a pixel a
// substep.  One launch a substep (the port's first kernel) sent the whole
// plane through L2 every substep: 15.2 us a launch against 0.75 us of
// bound, and 250 launches a climate dispatch.
//
// Design: temporal blocking on full-width row bands (bands.cuh).  One
// launch runs `steps` substeps (kernels/bands.py: at most 8, so 2 launches
// a 10-substep coupled step and 32 a 250-substep dispatch).  A cluster of
// blocks loads a band of th rows plus `steps` halo rows a side, T and
// cinv, whole, into its shared memory once, runs the substeps there (each
// reads the rows one above and below at the row's own corner shifts, so
// the band's right rows shrink by one a substep; the polar rows' shifts
// reach up to the whole row, across the cluster's blocks), and writes its
// th rows.  The TPU kernel's pole halos are antipodal mirrors that are
// right because the corner sum is symmetric in +-dy; here the halo rows
// past a pole are the physical rows themselves, read with their own
// neighbours, so they are right whatever the stencil.
// tests/test_torch_climate_tiles.py runs this schedule in numpy against
// the twin.

#include "bands.cuh"

namespace {

// a row of the band table: physical row, north row and column offset,
// south row and offset, the signed corner shifts, and whether every read
// of the row is near (no pole crossed, shifts within the margin)
constexpr int kRowInts = 8;
constexpr int kCells = 4;  // cells a lane takes at once
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// floats past the last plane: an item's lanes past the block's columns
// read (and never store) up to 32 * kCells - 1 columns on
constexpr int kSlack = 32 * kCells;

__host__ __device__ constexpr size_t band_floats(int eh, int seg) {
  return (size_t)eh * (kRowInts + 2 * (seg + 2 * bands::kMargin) + seg) +
         kSlack;
}

__global__ void __launch_bounds__(kThreads, 1) climate_band_kernel(
    const float* __restrict__ T, const float* __restrict__ cinv,
    const float* __restrict__ asr, const int* __restrict__ shifts,
    float* __restrict__ out, int H, int W, int wrap_s, int wrap_n,
    int pole_shift, int steps, int seg, int th, float diff_scale,
    float olr_coef) {
  namespace cg = bands::cg;
  constexpr int M = bands::kMargin;
  cg::cluster_group cluster = cg::this_cluster();
  const int eh = th + 2 * steps;
  const int r0 = bands::band_of(blockIdx.y, gridDim.y) * th;
  const int c0 = (int)cluster.block_rank() * seg;
  const int ncols = min(seg, W - c0);
  const int stride = seg + 2 * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = W % 4 == 0 && seg % 4 == 0;
  // band_smem: the row table, T in two buffers with margins, cinv
  int* const rows = (int*)bands::band_smem;
  const int off0 = kRowInts * eh, off1 = off0 + eh * stride;
  float* const tC = bands::band_smem + off1 + eh * stride;

  for (int j = tid; j < eh; j += kThreads) {
    int q, dir;
    bands::unfold(r0 - steps + j, H, q, dir);
    const int2 n = bands::row_source(q, dir, 1, H, wrap_s, wrap_n,
                                     pole_shift);
    const int2 s = bands::row_source(q, dir, -1, H, wrap_s, wrap_n,
                                     pole_shift);
    const int kn = bands::signed_shift(__ldg(shifts + q), W);
    const int kp = bands::signed_shift(__ldg(shifts + H + q), W);
    *reinterpret_cast<int4*>(rows + kRowInts * j) =
        make_int4(q, min(max(j + n.x, 0), eh - 1), n.y,
                  min(max(j + s.x, 0), eh - 1));
    *reinterpret_cast<int4*>(rows + kRowInts * j + 4) =
        make_int4(s.y, kn, kp,
                  n.y == 0 && s.y == 0 && -M <= kn && kn <= M &&
                      -M <= kp && kp <= M);
  }
  __syncthreads();

  // load the band's T, with its margins, and cinv: whole rows across the
  // cluster
  for (int j = warp; j < eh; j += kWarps) {
    const long g = (long)rows[kRowInts * j] * W;
    bands::load_row(bands::band_smem + off0 + j * stride + M, T + g, c0, -M,
                    ncols + M, W, vec, lane);
    bands::load_row(tC + j * seg, cinv + g, c0, 0, ncols, W, vec, lane);
  }
  bands::wait_copies();
  cluster.sync();

  // an item is kCells cells of one row, 32 columns apart, a lane: their
  // loads all go out before the first sum
  const int groups = (ncols + 32 * kCells - 1) / (32 * kCells);
  const unsigned inv_groups = bands::reciprocal(groups);
  for (int t = 1; t <= steps; ++t) {
    const bands::Plane a((t & 1) ? off0 : off1, seg, c0, ncols);
    const bands::Plane z((t & 1) ? off1 : off0, seg, c0, ncols);
    const float* const asr_s = asr + (long)(t - 1) * H;
    const int items = (eh - 2 * t) * groups;
    for (int it = warp; it < items; it += kWarps) {
      const int jr = bands::divide(it, inv_groups);
      const int j = t + jr;
      const int l0 = (it - jr * groups) * 32 * kCells + lane;
      const int4 r1 = *reinterpret_cast<const int4*>(rows + kRowInts * j);
      const int4 r2 =
          *reinterpret_cast<const int4*>(rows + kRowInts * j + 4);
      const int jn = r1.y, on = r1.z, js = r1.w, os = r2.x;
      const int kn = r2.y, kp = r2.z;
      const float ar = __ldg(asr_s + r1.x);
      float v[kCells][4], tv[kCells], cv[kCells];
      if (r2.w) {
#pragma unroll
        for (int u = 0; u < kCells; ++u) {
          v[u][0] = a.near(jn, l0 + 32 * u + kn);
          v[u][1] = a.near(js, l0 + 32 * u + kn);
          v[u][2] = a.near(jn, l0 + 32 * u + kp);
          v[u][3] = a.near(js, l0 + 32 * u + kp);
        }
      } else {
#pragma unroll
        for (int u = 0; u < kCells; ++u) {
          const int c = c0 + min(l0 + 32 * u, ncols - 1);
          v[u][0] = a.far(jn, bands::wrap(c + kn + on, W));
          v[u][1] = a.far(js, bands::wrap(c + kn + os, W));
          v[u][2] = a.far(jn, bands::wrap(c + kp + on, W));
          v[u][3] = a.far(js, bands::wrap(c + kp + os, W));
        }
      }
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        tv[u] = a.near(j, l0 + 32 * u);
        cv[u] = tC[j * seg + l0 + 32 * u];
      }
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const float left = __fadd_rn(v[u][0], v[u][1]);
        const float right = __fadd_rn(v[u][2], v[u][3]);
        const float lap = __fsub_rn(
            __fmul_rn(2.0f, __fadd_rn(left, right)), __fmul_rn(8.0f, tv[u]));
        const float tk = __fadd_rn(tv[u], 273.15f);
        const float t2 = __fmul_rn(tk, tk);
        const float olr = __fmul_rn(olr_coef, __fmul_rn(t2, t2));
        const float change = __fadd_rn(__fsub_rn(ar, olr),
                                       __fmul_rn(diff_scale, lap));
        if (l0 + 32 * u < ncols)
          z.push(j, l0 + 32 * u, __fadd_rn(tv[u], __fmul_rn(change, cv[u])),
                 W);
      }
    }
    cluster.sync();
  }

  // the band's own rows
  const bands::Plane res((steps & 1) ? off1 : off0, seg, c0, ncols);
  for (int j = steps + warp; j < steps + th; j += kWarps) {
    const int r = r0 + j - steps;
    if (r >= H) break;
    bands::store_row(out + (long)r * W + c0, &res.near(j, 0), ncols, vec,
                     lane);
  }
}

}  // namespace

extern "C" {

// `steps` substeps from T into out, in one launch of bands of th rows,
// `cluster` blocks of `seg` columns each (kernels/bands.py plans them).
// asr: (steps, H) table; shifts: (2, H) int table (kneg row, then kpos
// row, each mod W).  A geometry that does not cover the grid, or shared
// memory beyond a block's, is refused with cudaErrorInvalidValue.
int demiurge_climate_band(const float* T, const float* cinv,
                          const float* asr, const int* shifts, float* out,
                          int H, int W, int wrap_s, int wrap_n,
                          int pole_shift, int steps, int cluster, int seg,
                          int th, float diff_scale, float olr_coef,
                          void* stream) {
  if (!bands::accepted(W, H, cluster, seg, th, steps))
    return (int)cudaErrorInvalidValue;
  const int eh = th + 2 * steps;
  const size_t smem = sizeof(float) * band_floats(eh, seg);
  const int nbands = (H + th - 1) / th;
  return (int)bands::launch(climate_band_kernel, kThreads, cluster, nbands,
                            smem,
                            (cudaStream_t)stream, T, cinv, asr, shifts, out,
                            H, W, wrap_s, wrap_n, pole_shift, steps, seg, th,
                            diff_scale, olr_coef);
}

// Clusters of `cluster` blocks with `smem` bytes each that the card holds
// at once.
int demiurge_climate_band_clusters(int cluster, int smem) {
  return bands::max_clusters(climate_band_kernel, kThreads, cluster,
                             (size_t)smem);
}

}  // extern "C"

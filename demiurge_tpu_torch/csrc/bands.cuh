// Full-width row bands in a thread-block cluster, for Hopper (sm_90a).
// Shared by the temporally blocked climate (climate.cu) and blur (blur.cu)
// kernels; kernels/bands.py plans the launches.
//
// A band is th output rows of the grid plus `halo` rows on each side, all
// of them full width.  Its eh = th + 2 * halo extended rows live in the
// shared memory of a cluster of C blocks: block `rank` holds columns
// [rank * seg, rank * seg + seg) of every extended row, so a read at any
// column of any row of the band is a load from some block's shared memory
// (distributed shared memory).  That is what the polar rows need: their
// taps reach hundreds of columns (652 for the climate's corner taps at
// 2048x1024, 402 for the blur's), and nothing narrower than the whole row
// holds their reach over several iterations.
//
// Extended row j of the band whose first output row is r0 stands for the
// unfolded grid row e = r0 - halo + j: past a pole lie the rows on the far
// side of it, pole after pole (row H + i is row H-1-i, row 2H + i is row
// i, ...; likewise below 0).  Unlike the Jacobi tiles, a band stores every
// extended row in the grid's own column order, whole: an extended row is a
// copy of a physical row, and a cell of it computes exactly what that
// physical cell computes, with its row's tables, reading its physical
// neighbours where row_source finds them in the band (the same physical
// row, the same column).  So no symmetry of the stencil is needed and odd
// widths need no column fix.  A pole that does not wrap clamps: the
// extended rows past it are filled with arbitrary rows that no valid cell
// reads.  A pass whose vertical reach is R leaves the rows within R of the
// band's edge wrong; the band computes only the rows still right, and its
// th output rows are right after the last pass.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace bands {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may ask for

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// the physical row of unfolded row e, and its orientation (+1 as the grid
// runs, -1 past an odd number of poles)
__device__ __forceinline__ void unfold(int e, int H, int& phys, int& dir) {
  const int m = floordiv(e, H);
  const int q = e - m * H;
  const bool odd = m & 1;
  phys = odd ? H - 1 - q : q;
  dir = odd ? -1 : 1;
}

// Where physical row q finds the row it reads at row offset k, as the
// port's core.topology.shift resolves it: (extended-row step, column
// offset).  Within the grid the step is dir * k; beyond a pole that wraps
// (|k| < H) it is dir * k too, which lands on the mirrored row, read
// pole_shift columns round; otherwise the edge row itself at the same
// column, which lies at most |k| rows away in the band.
__device__ __forceinline__ int2 row_source(int q, int dir, int k, int H,
                                           int wrap_s, int wrap_n,
                                           int pole_shift) {
  const int rr = q + k;
  if (rr >= H) {
    if (wrap_n && k < H) return make_int2(dir * k, pole_shift);
    return make_int2(dir * (H - 1 - q), 0);
  }
  if (rr < 0) {
    if (wrap_s && -k < H) return make_int2(dir * k, pole_shift);
    return make_int2(-dir * q, 0);
  }
  return make_int2(dir * k, 0);
}

// The band of cluster row y of nb: the polar bands first (0, nb-1, 1,
// nb-2, ...), so that the slowest (their rows reach across the cluster)
// start in the first wave and the others fill in around them.
__device__ __forceinline__ int band_of(int y, int nb) {
  return (y & 1) ? nb - 1 - (y >> 1) : y >> 1;
}

// one float from device memory to shared memory, asynchronously (Ampere's
// cp.async): a block's loads all go in flight before it waits once
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// A warp copies grid columns c0 + lo ... c0 + hi - 1 (mod W) of a row to
// dst[lo ... hi - 1], 16 bytes a lane where the columns allow it (W, c0,
// lo and hi multiples of 4: no run of four crosses the dateline).
__device__ __forceinline__ void load_row(float* dst, const float* row,
                                         int c0, int lo, int hi, int W,
                                         bool vec, int lane) {
  if (vec) {
    for (int lx = lo + 4 * lane; lx < hi; lx += 128) {
      int x = (c0 + lx) % W;
      if (x < 0) x += W;
      copy_async16(dst + lx, row + x);
    }
  } else {
    for (int lx = lo + lane; lx < hi; lx += 32) {
      int x = (c0 + lx) % W;
      if (x < 0) x += W;
      copy_async(dst + lx, row + x);
    }
  }
}

// A warp stores src[0 ... n - 1] to row[0 ... n - 1].
__device__ __forceinline__ void store_row(float* row, const float* src,
                                          int n, bool vec, int lane) {
  if (vec) {
    for (int i = 4 * lane; i < n; i += 128)
      *reinterpret_cast<float4*>(row + i) =
          *reinterpret_cast<const float4*>(src + i);
  } else {
    for (int i = lane; i < n; i += 32) row[i] = src[i];
  }
}

// a / b for 0 <= a < 2^16, 1 <= b < 2^16, as one multiply by
// ceil(2^32 / b) (exact there: a * (ceil(2^32 / b) * b - 2^32) < 2^32);
// b = 1, whose multiplier does not fit 32 bits, keeps 0 and divides as is
__device__ __forceinline__ unsigned reciprocal(int b) {
  return b == 1 ? 0u : (unsigned)((0x100000000ull + b - 1) / b);
}

__device__ __forceinline__ int divide(int a, unsigned inv_b) {
  return inv_b ? (int)__umulhi((unsigned)a, inv_b) : a;
}

// x mod W for -W <= x < 2W
__device__ __forceinline__ int wrap(int x, int W) {
  if (x >= W) x -= W;
  if (x < 0) x += W;
  return x;
}

// One band's plane.  Every block keeps its `ncols` columns of each row and
// kMargin columns on either side, copies of its neighbours' (the row's
// grid columns c0 - kMargin ... c0 + ncols + kMargin - 1, mod W): a read
// whose column shift is at most kMargin is near(), a load from the block's
// own shared memory at a fixed offset; any other (the polar rows' taps,
// hundreds of columns out, and reads across a pole, half a world round)
// is far(), from the block that holds the column.  A far row's cell takes
// every address first and loads them together, so that its reads of other
// blocks' shared memory, hundreds of cycles away, overlap.  A pass that
// writes a plane read at shifts stores each cell with push(), which also
// writes the cell into the margins of the neighbours that copy it (every
// block holds at least kMargin columns, so only the two beside it do);
// the cluster barrier after the pass makes the margins whole.
constexpr int kMargin = 32;

// the block's dynamic shared memory; planes and tables are offsets into
// it, so that every access of the block's own copy is a shared-memory
// load or store (a generic pointer would send it down the global path)
extern __shared__ float band_smem[];

struct Plane {
  int off;  // the plane's first float in band_smem
  int stride, seg, c0, ncols;
  unsigned inv_seg;  // ceil(2^32 / seg): x / seg as one multiply

  __device__ __forceinline__ Plane(int off_, int seg_, int c0_, int ncols_)
      : off(off_), stride(seg_ + 2 * kMargin), seg(seg_), c0(c0_),
        ncols(ncols_), inv_seg(reciprocal(seg_)) {}

  // row j, the block's column lx (-kMargin <= lx < ncols + kMargin)
  __device__ __forceinline__ float& near(int j, int lx) const {
    return band_smem[off + j * stride + kMargin + lx];
  }

  // row j, grid column x (0 <= x < W), from whichever block holds it
  __device__ __forceinline__ float far(int j, int x) const {
    const int lx = x - c0;
    if ((unsigned)lx < (unsigned)ncols) return near(j, lx);
    const int owner = divide(x, inv_seg);
    return *cg::this_cluster().map_shared_rank(&near(j, x - owner * seg),
                                               (unsigned)owner);
  }

  // row j, the block's column lc, here and in the neighbours' margins
  __device__ __forceinline__ void push(int j, int lc, float v, int W) const {
    near(j, lc) = v;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    if (lc < kMargin) {  // the right margin of the block to the west
      const int left = rank == 0 ? C - 1 : rank - 1;
      const int nl = min(seg, W - left * seg);
      *cluster.map_shared_rank(&near(j, nl + lc), (unsigned)left) = v;
    }
    if (lc >= ncols - kMargin)  // the left margin of the block to the east
      *cluster.map_shared_rank(&near(j, lc - ncols),
                               (unsigned)(rank + 1 == C ? 0 : rank + 1)) = v;
  }
};

// the shift k (mod W) as the nearest signed shift, |k| <= W/2
__device__ __forceinline__ int signed_shift(int k, int W) {
  return 2 * k > W ? k - W : k;
}

// Launch `kernel` on a grid of (cluster, bands) blocks in clusters of
// `cluster` along x, `smem` bytes of dynamic shared memory each.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int threads, int cluster,
                   int nbands, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, nbands, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of `kernel`, `smem` bytes each,
// the card holds at once (0 where it cannot launch them).
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int threads, int cluster,
                 size_t smem) {
  if (smem > kMaxSmem ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cluster > 8 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The launch geometry kernels/bands.py plans, checked: a power-of-two
// cluster of at most kMaxCluster blocks whose segments cover the width,
// each at least kMargin columns wide.
inline bool accepted(int W, int H, int cluster, int seg, int th, int halo) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return false;
  if (seg < 2 || W > 65536 || (long)seg * cluster < W ||
      W - seg * (cluster - 1) < kMargin)
    return false;
  return th >= 1 && halo >= 1 && W >= 1 && H >= 1;
}

}  // namespace bands

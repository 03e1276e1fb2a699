// Interpolation with a separable window between a uniform n^3 grid and
// non-uniform points (kb_gather) and its adjoint, spreading onto the grid
// (kb_scatter), for NVIDIA Hopper, built for sm_90a with nvcc into a shared
// library with a plain C interface (loaded by tike_tpu_torch/kernels.py
// through ctypes). The window is the plan's: Kaiser-Bessel, or the Gaussian
// of the original tike's usfft.cu gather/scatter.
//
// What they replace. The JAX package has no Pallas kernel for these: it
// writes the interpolation as XLA code shaped for the TPU. gather_kb and
// scatter_kb (tike_tpu/ops/usfft.py:214-271) scan the (2m)^3 taps, one
// batched gather or scatter-add of all N points per tap; gather_kb_rows and
// scatter_kb_rows (:330-397), which laminography runs, spread each axis's
// 2m taps into dense length-n rows and contract them with einsums on the
// matrix unit; gather and scatter (:400-457), the Gaussian window, scan the
// taps as gather_kb and scatter_kb do, with an exp per 3-D tap.
//
// Semantics (tike_tpu/ops/usfft.py). The grid is the centred, fftshifted
// transform, n^3 complex64 seen as float2. Point i has frequencies x[i] (3
// float32, any real value: laminography's plane corners lie outside
// [-0.5, 0.5) and wrap). On each axis, v = n x (rounded once); the plan
// gives the point a base cell b, and its 2m taps are the cells b + 1 - m ...
// b + m (mod n), tap j with the plan's axis weight w[j]. A 3-D tap's weight
// is (w0 w1) w2, in that order, as in the JAX package. The windows:
//   Kaiser-Bessel: b = (n/2 + floor(v)) mod n and
//     w[j] = I0(beta sqrt(1 - (d/m)^2)) / I0(beta),   d = v - floor(v) - (j + 1 - m);
//   Gaussian: b = (n/2 + floor(v) - 1) mod n, so the taps are floor(v) - m
//     ... floor(v) + m - 1 as in the JAX package, and
//     w[j] = exp(-pi^2/mu d^2) (axis 0's times (pi/mu)^(3/2)),
//     d = (floor(v) - m + j) / n - x:
//   the JAX package's cons0 exp(cons1 |d|^2) split into its three axis
//   factors, so no exp is left per 3-D tap.
//
// The geometry plan. Everything above depends on the points alone, and
// laminography's points never change within a reconstruction. So the
// kernels read a plan that tike_tpu_torch/ops/usfft.py::geometry_plan builds once
// per set of points: the points sorted by the linear index of their base
// cell ("bin", axis 2 fastest; ties in ascending point index), and for the
// sorted point p
//     rows[p]      its row of bins c0 n + c1 (int32),
//     cols[p]      its column c2 (int16),
//     order[p]     its index in the caller's arrays,
//     weights[..p] its 3 x 2m axis weights (the plain version's, to the bit;
//                  stored [axis][tap][point], so a warp's loads coalesce),
//     row_start[r] for each of the n^2 rows of bins r (and n^2 itself), where
//                  the points of row r start in the sorted list.
// No index of a cell is formed in 32 bits beyond a row c0 n + c1 (n^2 < 2^31
// for any grid a card holds; n^3 passes 2^31 above n = 1290): a grid
// offset is (long long)(c0 n + c1) n + c2. The scatters read the sort only
// at the starts of rows of bins, so the plan holds n^2 + 1 of them, not a
// start per cell (8.6 GB at n = 1292). No Bessel function, exp, division or
// floor is left in the kernels but one division by n a point in the
// gather. The gather takes the points in any order (it reads no
// row_start); for m = 1 its plan sorts them by 8 x 8 tiles of cells on axes
// 1 and 2 instead, ties again in ascending index.
//
// What bounds them on this card: bytes. A gather must read the grid values
// its points touch (at laminography's 128^3 grid and 64 angles, 60% of the
// 16.8 MB), the 12 bytes of each point's x, and write 8 bytes per point; a
// scatter reads the values and x and writes the whole grid once: 31 and
// 37.7 MB there, 9 and 11 us at 3.35 TB/s. The arithmetic is under a tenth
// of that at m = 1. What held the earlier one-thread-per-point kernels far
// from it: 6m Bessel functions per point and launch; tap loads along a
// line across the grid's rows, a new sector for most lanes of a warp; and
// in the scatter (2m)^3 float2 atomics per point into L2, about 100 G
// atomics/s whatever the case, behind a separate memset of the grid; the
// atomics' order, and so the result's last bits, varied from launch to
// launch.
//
// kb_gather_kernel: one thread per point in the plan's order; the weights
// come from the table; the sum runs over the taps in the plain version's
// order (axis 0 outermost) and goes to out[order[p]]. In bin order a
// warp's points share base cells or lie in neighbouring ones along axis 2,
// so their taps fall in the same sectors, but its 32 stores go to 32
// sectors of out. That is the better trade while taps dominate (m = 2: 64
// taps a point). At m = 1 the tile order wins: within a tile the points
// keep their order along laminography's lines, so runs of neighbouring
// lanes store neighbouring outputs, and their taps still share a few rows.
// What it moves is the plan, 34 bytes a point at m = 1 against x's 12: at
// 128^3 / 64 angles that, not the taps, is most of its traffic, and with
// the grid and the output it is a little more than the 50 MB L2 holds. So
// the plan is read with streaming loads and the output written with
// streaming stores (evict first), which keeps the grid in the L2 from one
// launch to the next: a fifth faster there, no change where the grid alone
// exceeds the L2 (256^3).
//
// kb_scatter_kernel: the scatter turned into an owned gather. One block
// owns one row of the grid, the n cells (c0, c1, .) along axis 2. The row
// receives from the points whose base cell lies in the rows (c0 + m - 1 -
// j0, c1 + m - 1 - j1) of bins, j0, j1 = 0 ... 2m - 1, and each such row's
// points are one run of the sorted list, between two row_start reads. The
// runs, 32 points to a chunk, are dealt to the block's warps in turn. A
// warp takes a chunk one point per lane (whole coalesced loads of the
// table; the values come through order[p] from L2). The base cells b2 of
// the chunk ascend, so lanes with equal b2 are neighbours: for each tap j2
// a segmented sum by shuffles leaves each segment's total in its last
// lane, which adds it to cell b2 + 1 - m + j2 of the warp's own copy of
// the row in shared memory; no two lanes hit one cell in one step. At the
// end the copies are added in the warps' order and the row is stored,
// zeros where nothing landed. No atomics, no memset, every cell written
// exactly once, every addition in an order the plan fixes: two launches
// agree to the bit. Work goes where the points are: a thread per cell
// instead left most lanes idle on laminography's points (a few cells near
// the rotation axis receive hundreds of points, the mean is four) and ran
// slower than the atomics. What bounds it now is instruction throughput,
// about 150 instructions a chunk (finding the chunk's row, ten loads with their address
// arithmetic, the segments, and per tap the products, the shuffles and the
// shared-memory add), with rows of bins of 18 to 74 points filling 56 to
// 77% of a chunk's lanes: values already in sorted order, two chunks'
// loads in flight per warp, 2, 3 or 8 warps a block, and chunks that run on
// over neighbouring rows of bins (full lanes, but a division per point and
// the rows taking turns at the shared-memory adds) were each measured and
// moved it by a few percent at most, or made it slower.
//
// m is a template parameter for m = 1 and 2 (KB at upsample 1 and 2, the
// Gaussian at upsample 1) and for m = 4 (the Gaussian at upsample 2, eps
// 1e-3), where the tap loops unroll and the scatter keeps a point's axis-2
// weights in registers; a run-time value in one generic instantiation that
// unrolls nothing, for any m >= 1 with 2m <= n. On the Gaussian's plans at
// 128^3 / 64 angles (python -m tike_tpu_torch.kernel_sweep --source
// gaussian, H100 SXM at 700 W) the generic instantiation took, for the
// gather and the scatter, 0.552 and 2.012 ms at m = 4 and 1.716 and 6.056 ms
// at m = 6, unrolled ones 0.419 and 1.406, 1.330 and 4.190 ms. No path runs
// m = 6 (the Gaussian at eps 1e-5, upsample 2), so it takes the generic
// instantiation; the sweep's "m = 6 unrolled" variant brings it back.
// Above m = 2 the gather unrolls the (2m)^2 taps of one axis-0 tap, not all
// (2m)^3: unrolled whole, it took 0.456 and 1.587 ms, and nvcc 52 s for this
// file against 4.5.
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kGatherThreads = 256;
// Warps per scatter block, which share the points of one row of the grid.
constexpr int kScatterWarps = 4;
constexpr unsigned kFullWarp = 0xffffffffu;
// Shared memory a block may use on sm_90 once it opts in: the scatter's
// copies of a row, kScatterWarps n float2, up to n = 7264.
constexpr int kMaxShared = 232448;

// i in [-n, 2n) brought into [0, n).
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// M > 0: the half-support at compile time; M = 0: m at run time.
template <int M>
__global__ void __launch_bounds__(kGatherThreads)
    kb_gather_kernel(const float2* __restrict__ grid,
                     const int* __restrict__ rows,
                     const short* __restrict__ cols,
                     const int* __restrict__ order,
                     const float* __restrict__ weights,
                     float2* __restrict__ out, long long npoints, int n,
                     int m_runtime) {
  const int m = M ? M : m_runtime;
  const int taps = 2 * m;
  const long long p =
      static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (p >= npoints) return;
  const int cell_row = __ldcs(rows + p);
  const int b2 = __ldcs(cols + p);
  const int b0 = cell_row / n;
  const int b1 = cell_row - b0 * n;
  // The first tap's cell on each axis; the others follow, wrapping at n.
  const int s0 = wrap(b0 + 1 - m, n);
  const int s1 = wrap(b1 + 1 - m, n);
  const int s2 = wrap(b2 + 1 - m, n);
  // weights[axis][tap][point]: a warp's loads of one tap are contiguous.
  // A point's plan is read once and its output written once: streaming
  // loads and stores (evict first), so that they do not push the grid,
  // which every point's neighbours read again, out of the L2.
  const float* __restrict__ w0 = weights + p;
  const float* __restrict__ w1 = w0 + taps * npoints;
  const float* __restrict__ w2 = w1 + taps * npoints;
  float2 acc = make_float2(0.0f, 0.0f);
  if constexpr (M > 0) {
    // Above m = 2 the axis-0 loop stays a loop around its unrolled (2m)^2
    // taps (see the header).
    constexpr int kUnroll0 = M <= 2 ? 2 * M : 1;
    float r0[2 * M], r1[2 * M], r2[2 * M];
    int g2[2 * M];
#pragma unroll
    for (int j = 0; j < 2 * M; ++j) {
      if constexpr (kUnroll0 > 1) r0[j] = __ldcs(w0 + j * npoints);
      r1[j] = __ldcs(w1 + j * npoints);
      r2[j] = __ldcs(w2 + j * npoints);
      g2[j] = s2 + j >= n ? s2 + j - n : s2 + j;
    }
#pragma unroll kUnroll0
    for (int j0 = 0; j0 < 2 * M; ++j0) {
      const int g0 = s0 + j0 >= n ? s0 + j0 - n : s0 + j0;
      float a0;
      if constexpr (kUnroll0 > 1) a0 = r0[j0];
      else a0 = __ldcs(w0 + j0 * npoints);
#pragma unroll
      for (int j1 = 0; j1 < 2 * M; ++j1) {
        const int g1 = s1 + j1 >= n ? s1 + j1 - n : s1 + j1;
        const float w01 = __fmul_rn(a0, r1[j1]);
        const float2* __restrict__ row =
            grid + (static_cast<long long>(g0) * n + g1) * n;
#pragma unroll
        for (int j2 = 0; j2 < 2 * M; ++j2) {
          const float w = __fmul_rn(w01, r2[j2]);
          const float2 v = __ldg(row + g2[j2]);
          acc.x = fmaf(v.x, w, acc.x);
          acc.y = fmaf(v.y, w, acc.y);
        }
      }
    }
  } else {
#pragma unroll 1
    for (int j0 = 0; j0 < taps; ++j0) {
      const int g0 = s0 + j0 >= n ? s0 + j0 - n : s0 + j0;
      const float wa = __ldg(w0 + j0 * npoints);
#pragma unroll 1
      for (int j1 = 0; j1 < taps; ++j1) {
        const int g1 = s1 + j1 >= n ? s1 + j1 - n : s1 + j1;
        const float w01 = __fmul_rn(wa, __ldg(w1 + j1 * npoints));
        const float2* __restrict__ row =
            grid + (static_cast<long long>(g0) * n + g1) * n;
#pragma unroll 1
        for (int j2 = 0; j2 < taps; ++j2) {
          const int g2 = s2 + j2 >= n ? s2 + j2 - n : s2 + j2;
          const float w = __fmul_rn(w01, __ldg(w2 + j2 * npoints));
          const float2 v = __ldg(row + g2);
          acc.x = fmaf(v.x, w, acc.x);
          acc.y = fmaf(v.y, w, acc.y);
        }
      }
    }
  }
  __stcs(out + __ldcs(order + p), acc);
}

// One sorted point per lane, as the scatter holds it between its loads and
// its additions.
template <int M>
struct Chunk {
  int p;      // the point's place in the sorted list
  int b2;     // its base cell along axis 2; lanes past the run's end get one
              // of their own (negative)
  bool valid;
  float2 v;   // its value
  float w01;  // w0[j0] w1[j1] for the row of bins it came from
  float w2[M ? 2 * M : 1];  // its axis-2 weights (M > 0)
};

// The scatter's work for one row of cells is a list of items: the 32-point
// chunks of the (up to 32) rows of bins whose starts and ends the lanes
// hold in my_first and my_last (chunks_through: the chunks of rows 0 ...
// lane). Loads the points of item (< the rows' chunks in all), one per
// lane; a point's column is its base cell along axis 2.
template <int M>
__device__ __forceinline__ Chunk<M> load_chunk(
    int item, int chunks_through, int my_chunks,
    int my_first, int my_last, int first_row, int lane, int taps,
    long long npoints, const float2* __restrict__ values,
    const short* __restrict__ cols, const int* __restrict__ order,
    const float* __restrict__ weights) {
  Chunk<M> c;
  c.b2 = -1 - lane;
  c.v = make_float2(0.0f, 0.0f);
  c.w01 = 0.0f;
  // The row of bins this item lies in: the first whose chunks reach it.
  const int k = __ffs(__ballot_sync(kFullWarp, chunks_through > item)) - 1;
  const int last = __shfl_sync(kFullWarp, my_last, k);
  const int chunk = item - __shfl_sync(kFullWarp, chunks_through - my_chunks, k);
  c.p = __shfl_sync(kFullWarp, my_first, k) + 32 * chunk + lane;
  c.valid = c.p < last;
  if (c.valid) {
    const float* __restrict__ w = weights + c.p;
    c.b2 = __ldg(cols + c.p);
    c.v = __ldg(values + __ldg(order + c.p));
    c.w01 = __fmul_rn(__ldg(w + ((first_row + k) / taps) * npoints),
                      __ldg(w + (taps + (first_row + k) % taps) * npoints));
    if constexpr (M > 0) {
#pragma unroll
      for (int j2 = 0; j2 < 2 * M; ++j2)
        c.w2[j2] = __ldg(w + (2 * taps + j2) * npoints);
    }
  }
  return c;
}

// Adds a chunk's points to the warp's copy of the row, acc. The base cells
// b2 of a chunk ascend, so lanes with equal b2 are neighbours: for each tap
// j2 a segmented sum by shuffles leaves each segment's total in its last
// lane, which adds it to cell b2 + 1 - m + j2.
template <int M>
__device__ __forceinline__ void add_chunk(const Chunk<M>& c,
                                          float2* __restrict__ acc, int lane,
                                          int m, int n,
                                          const float* __restrict__ weights,
                                          long long npoints) {
  const int taps = 2 * m;
  // The lanes that start a segment of equal b2, each lane's distance from
  // its segment's start, and the longest segment.
  const int up = __shfl_up_sync(kFullWarp, c.b2, 1);
  const unsigned heads = __ballot_sync(kFullWarp, lane == 0 || up != c.b2);
  const int dist = lane - (31 - __clz(heads & (kFullWarp >> (31 - lane))));
  const int longest = __reduce_max_sync(kFullWarp, dist);
  const bool is_tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  constexpr int kUnroll = M ? 2 * M : 1;
#pragma unroll kUnroll
  for (int j2 = 0; j2 < taps; ++j2) {
    float2 t = make_float2(0.0f, 0.0f);
    if (c.valid) {
      float w2j;
      if constexpr (M > 0) w2j = c.w2[j2];
      else w2j = __ldg(weights + (2 * taps + j2) * npoints + c.p);
      const float wgt = __fmul_rn(c.w01, w2j);
      t = make_float2(__fmul_rn(c.v.x, wgt), __fmul_rn(c.v.y, wgt));
    }
    // Inclusive sums within each segment, in a fixed order.
    for (int d = 1; d <= longest; d <<= 1) {
      const float x = __shfl_up_sync(kFullWarp, t.x, d);
      const float y = __shfl_up_sync(kFullWarp, t.y, d);
      if (dist >= d) {
        t.x += x;
        t.y += y;
      }
    }
    // A segment's last lane holds its sum; no two segments share a base
    // cell, so no two lanes add to one cell in this step.
    if (c.valid && is_tail) {
      const int cell = wrap(c.b2 + 1 - m + j2, n);
      acc[cell].x += t.x;
      acc[cell].y += t.y;
    }
    __syncwarp();
  }
}

template <int M>
__global__ void __launch_bounds__(32 * kScatterWarps)
    kb_scatter_kernel(const float2* __restrict__ values,
                      const short* __restrict__ cols,
                      const int* __restrict__ order,
                      const int* __restrict__ row_start,
                      const float* __restrict__ weights,
                      float2* __restrict__ grid, long long npoints, int n,
                      int m_runtime) {
  extern __shared__ float2 copies[];
  const int m = M ? M : m_runtime;
  const int taps = 2 * m;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int out_row = blockIdx.x;
  float2* __restrict__ acc = copies + warp * n;
  for (int c = lane; c < n; c += 32) acc[c] = make_float2(0.0f, 0.0f);
  __syncwarp();
  const int c0 = out_row / n, c1 = out_row % n;
  // The (2m)^2 rows of bins that reach this row of cells, taps (j0, j1) in
  // ascending order, up to 32 at a time: lane k reads where row k starts
  // and ends in the sorted list. The rows' points, 32 to a chunk, are the
  // items of work, dealt to the block's warps in turn.
  for (int first_row = 0; first_row < taps * taps; first_row += 32) {
    int my_first = 0, my_last = 0;
    if (first_row + lane < taps * taps) {
      const int r0 = wrap(c0 + m - 1 - (first_row + lane) / taps, n);
      const int r1 = wrap(c1 + m - 1 - (first_row + lane) % taps, n);
      const int my_row = r0 * n + r1;
      my_first = __ldg(row_start + my_row);
      my_last = __ldg(row_start + my_row + 1);
    }
    const int my_chunks = (my_last - my_first + 31) / 32;
    int chunks_through = my_chunks;  // of rows 0 ... lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int below = __shfl_up_sync(kFullWarp, chunks_through, d);
      if (lane >= d) chunks_through += below;
    }
    const int items = __shfl_sync(kFullWarp, chunks_through, 31);
    for (int item = warp; item < items; item += kScatterWarps) {
      const Chunk<M> c = load_chunk<M>(
          item, chunks_through, my_chunks, my_first, my_last,
          first_row, lane, taps, npoints, values, cols, order, weights);
      add_chunk<M>(c, acc, lane, m, n, weights, npoints);
    }
  }
  __syncthreads();
  float2* __restrict__ out = grid + static_cast<long long>(out_row) * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float2 sum = copies[c];
#pragma unroll
    for (int w = 1; w < kScatterWarps; ++w) {
      sum.x += copies[w * n + c].x;
      sum.y += copies[w * n + c].y;
    }
    out[c] = sum;
  }
}

template <int M>
cudaError_t launch_gather(const void* grid, const int* rows, const short* cols,
                          const int* order, const float* weights, void* out,
                          long long npoints, int n, int m, cudaStream_t stream) {
  const long long blocks = (npoints + kGatherThreads - 1) / kGatherThreads;
  kb_gather_kernel<M><<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                        stream>>>(static_cast<const float2*>(grid), rows, cols,
                                  order, weights, static_cast<float2*>(out),
                                  npoints, n, m);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_scatter(const void* values, const short* cols,
                           const int* order, const int* row_start,
                           const float* weights, void* grid, long long npoints,
                           int n, int m, cudaStream_t stream) {
  // Each warp's copy of the row, n float2 in shared memory: within the 48
  // KB a block gets without asking up to n = 1536; above, the block asks
  // for it, once a device.
  const long long bytes = static_cast<long long>(kScatterWarps) * n * sizeof(float2);
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    static bool opted[64] = {};
    int device = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc != cudaSuccess) return rc;
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!opted[device]) {
      rc = cudaFuncSetAttribute(kb_scatter_kernel<M>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
      if (rc != cudaSuccess) return rc;
      opted[device] = true;
    }
  }
  kb_scatter_kernel<M><<<static_cast<unsigned>(n) * n, 32 * kScatterWarps,
                         static_cast<size_t>(bytes), stream>>>(
      static_cast<const float2*>(values), cols, order, row_start, weights,
      static_cast<float2*>(grid), npoints, n, m);
  return cudaGetLastError();
}

// A row of bins c0 n + c1 is an int32 and a column an int16
// (tike_tpu_torch/ops/usfft.py's MAX_N): a grid of 2^45 cells, far past any
// card's memory.
constexpr int kMaxN = 32767;
bool valid(int n, int m) { return m >= 1 && 2 * m <= n && n <= kMaxN; }

}  // namespace

// out (npoints) complex64 = the grid (n^3 complex64, centred) interpolated
// at the points of a plan (rows, order: npoints int32; cols: npoints int16;
// weights: 3 x 2m x npoints float32) with the 2m-tap window.
extern "C" int tike_kb_gather(const void* grid, const void* rows, const void* cols,
                              const void* order, const void* weights,
                              void* out, long long npoints, int n, int m,
                              void* stream) {
  if (!valid(n, m) || npoints < 0 || npoints >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (npoints == 0) return static_cast<int>(cudaGetLastError());
  const int* r = static_cast<const int*>(rows);
  const short* c = static_cast<const short*>(cols);
  const int* o = static_cast<const int*>(order);
  const float* w = static_cast<const float*>(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch_gather<1>(grid, r, c, o, w, out, npoints, n, m, s));
    case 2: return static_cast<int>(launch_gather<2>(grid, r, c, o, w, out, npoints, n, m, s));
    case 4: return static_cast<int>(launch_gather<4>(grid, r, c, o, w, out, npoints, n, m, s));
    default: return static_cast<int>(launch_gather<0>(grid, r, c, o, w, out, npoints, n, m, s));
  }
}

// grid (n^3 complex64), every value written = the values (npoints complex64,
// in the caller's order) spread at the points of a plan (cols, order and
// weights as above, and row_start: n^2 + 1 int32); the adjoint of
// tike_kb_gather.
extern "C" int tike_kb_scatter(const void* values, const void* cols,
                               const void* order, const void* row_start,
                               const void* weights, void* grid,
                               long long npoints, int n, int m, void* stream) {
  if (!valid(n, m) || npoints < 0 || npoints >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const short* c = static_cast<const short*>(cols);
  const int* o = static_cast<const int*>(order);
  const int* rs = static_cast<const int*>(row_start);
  const float* w = static_cast<const float*>(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch_scatter<1>(values, c, o, rs, w, grid, npoints, n, m, s));
    case 2: return static_cast<int>(launch_scatter<2>(values, c, o, rs, w, grid, npoints, n, m, s));
    case 4: return static_cast<int>(launch_scatter<4>(values, c, o, rs, w, grid, npoints, n, m, s));
    default: return static_cast<int>(launch_scatter<0>(values, c, o, rs, w, grid, npoints, n, m, s));
  }
}

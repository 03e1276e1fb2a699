// Interpolation with the Gaussian window between a uniform n^3 grid and
// non-uniform points (gaussian_gather) and its adjoint, spreading onto the
// grid (gaussian_scatter), for NVIDIA Hopper, built for sm_90a with nvcc into
// a shared library with a plain C interface (loaded by
// tike_tpu_torch/kernels.py through ctypes).
//
// What they replace. tike_tpu's gather and scatter (tike_tpu/ops/usfft.py:
// 400-457, also vector_gather and vector_scatter :461-466), XLA code with no
// Pallas kernel that was the original tike's usfft.cu gather and scatter: a
// scan of the (2m)^3 taps, one batched gather or scatter-add of all N points
// a tap, each weight cons0 exp(cons1 |d|^2). They take over from the KB
// kernels of csrc/usfft.cu run on a Gaussian plan (the first form, still
// launchable as their yardstick: tests/_torch_usfft_cases.py::
// first_form_gather, first_form_scatter), which spent a thread a point and
// an 8-byte load a tap in the gather, and in the scatter loaded every point
// (2m)^2 times, once for each row of the grid it reaches.
//
// Semantics. The grid is the centred, fftshifted transform, n^3 complex64
// seen as float2. Point i has frequencies x[i] (3 float32, any real value;
// laminography's plane corners lie outside [-0.5, 0.5) and wrap). On each
// axis the plan gives the point a base cell b = (n/2 + floor(n x) - 1) mod n
// and its 2m taps are the cells b + 1 - m ... b + m (mod n), tap j with the
// axis factor w[j] = exp(-pi^2/mu d^2), d = (floor(n x) - m + j) / n - x
// (axis 0's times (pi/mu)^(3/2)): the JAX package's cons0 exp(cons1 |d|^2)
// split into three factors, so no exp is left in the kernels. A 3-D tap's
// weight is w0 w1 w2. The geometry plan (tike_tpu_torch/ops/usfft.py::
// geometry_plan(..., window="gaussian")) holds the points sorted by the
// linear index of their base cell ("bin", axis 2 fastest; ties in ascending
// point index): bins[p], order[p] (the index in the caller's arrays),
// weights[axis][tap][p], bin_start[c] for every cell c (and n^3), where bin
// c's points start in the sorted list, and the scatter's blocks. The weights
// carry no product order that has to be kept (the JAX function takes one
// exp a 3-D tap), so each kernel sums in an order of its own, fixed by the
// plan: tests/_torch_usfft_cases.py (gather_gaussian_kernel_order,
// scatter_gaussian_kernel_order) writes both out in plain code.
//
// What bounds them on this card. At laminography's 128^3 volume, 64 angles,
// eps 1e-3 (1,048,576 points), at upsample 2 (m = 4, a 256^3 grid) a point
// has 512 taps. The gather must read the 109 MB its points touch and the
// scatter write the 134 MB grid (33 and 46 us at 3.35 TB/s); the separable
// sum is 1.2 G FP32 instructions (37 us). Neither comes close: the gather
// is held by the L1's sectors (64 scattered row pieces a point), the
// scatter by the issue of its per-tap work (a product, the shuffles that
// find a run's total and a shared-memory add, for each tap and each row)
// and by the latency of its walks.
//
// gaussian_gather_thread_kernel (m <= kThreadGatherMaxM): a thread a point,
// its weights in registers, its (2m)^3 taps unrolled, the sum factored with
// axis 2 innermost. gaussian_gather_kernel (above): a group of 2m lanes
// (rounded up to a power of two) a point, lane j the point's axis-2 tap j,
// in the plan's order. For each of the point's (2m)^2 rows of taps the group
// loads the row's 2m cells, one float2 a lane: one load instruction covers
// 32 / 2m rows of neighbouring points, 2 or 3 sectors a row, where a thread
// a point covered up to 32 sectors for 32 taps. The sum is factored: per
// lane, sum_j0 w0[j0] sum_j1 w1[j1] G[j0, j1, j], two multiply-adds a tap
// (w0 and w1 broadcast in the group by shuffles), times w2[j]; then a
// butterfly of shuffles adds the group's lanes ((t0 + t4) + (t2 + t6)) +
// ((t1 + t5) + (t3 + t7)) at 2m = 8, and lane 0 writes out[order[p]].
// Both read the plan with streaming loads and write the output with
// streaming stores, so that they do not push the grid out of the L2.
//
// gaussian_scatter_kernel: owned bands, no atomics. A block owns a band of
// rows (along axis 1) of one plane c0 (band_rows: 4 up to m = 2, else 2),
// whole along axis 2, and each of its kScatterWarps warps a copy of the
// band in shared memory; it adds the copies in the warps' order and writes
// the band once, zeros where nothing landed: every cell of the grid written
// exactly once, no memset. The block walks the 2m x (rows + 2m - 1) rows
// of bins that reach the band, 32 at a time held by the lanes, and their
// points 32 to a chunk, the chunks dealt to the warps in turn: each point
// is loaded once a band, where the first form loaded it once a row of the
// grid, and w0 v is formed once. For each tap j2 a chunk's terms w1 (w2 (w0
// v)) go to each band row its row of bins reaches: a segmented sum by
// shuffles over the lanes of equal base cell leaves each run's total in
// its last lane, which adds it to the warp's copy; the runs' base cells are
// distinct, so no two lanes add to one cell. Every cell's sum runs in an
// order the plan and the band heights fix, so two launches agree to the
// bit. The blocks are the plan's, the bands with the most points first, so
// that the busy bands near laminography's rotation axis start first and do
// not end the launch alone.
//
// Measured and dropped (python -m tike_tpu_torch.kernel_sweep --source
// gaussian, H100 SXM at 700 W, 128^3 / 64 angles, m = 2 / 4): a scatter
// giving each thread a cell of the band, its sum in registers from the
// points staged in shared memory, 0.32-0.38 / 2.04 ms (this one 0.165 /
// 1.199); a gather staging a brick of 8^3 bins and its halo in shared
// memory, 0.585 ms at m = 4 (bricks of 4^3 and 16^3: 1.75 and 0.72; the
// groups 0.354): a brick holds 34 points (median) for 3,375 staged cells.
//
// m is a template parameter for m = 1, 2 and 4 (the Gaussian at upsample 1
// and 2, eps 1e-3) and, in the gather, 3 and 6 (eps 1e-5), where the loops
// unroll; a run-time value in one generic instantiation for any other m with
// 2m <= 32 and 2m <= n.
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kGatherThreads = 256;
// Axis-0 taps of the gather's loop unrolled together (loads in flight).
constexpr int kGatherUnroll0 = 2;
// The largest m whose gather takes a thread a point (gaussian_gather_thread_
// kernel); above it, a group of lanes a point (gaussian_gather_kernel).
constexpr int kThreadGatherMaxM = 2;
constexpr int kThreadGatherThreads = 128;
// Rows (along axis 1) of one plane a scatter block owns (band_rows): for m
// <= 2, kBandRowsSmallM; above, kBandRowsLargeM.
constexpr int kBandRowsSmallM = 4;
constexpr int kBandRowsLargeM = 2;
// A scatter block's warps, each with its copy of the band.
constexpr int kScatterWarps = 4;
// A lane a tap along axis 2: 2m <= 32.
constexpr int kMaxTaps = 32;
// The kernels index bins and bin_start with 32-bit integers.
constexpr int kMaxN = 1290;
// Shared memory a block may use on sm_90 once it opts in.
constexpr int kMaxShared = 232448;

// M: the instantiation's half-support (0: generic, m > 2).
__host__ __device__ constexpr int band_rows(int M) {
  return M != 0 && M <= 2 ? kBandRowsSmallM : kBandRowsLargeM;
}

// i in [-n, 2n) brought into [0, n).
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// The lanes a point takes along axis 2: 2m rounded up to a power of two.
__host__ __device__ constexpr int group_width(int taps) {
  int width = 1;
  while (width < taps) width <<= 1;
  return width;
}

// M > 0: the half-support at compile time; M = 0: m at run time.
template <int M>
__global__ void __launch_bounds__(kGatherThreads)
    gaussian_gather_kernel(const float2* __restrict__ grid,
                           const int* __restrict__ bins,
                           const int* __restrict__ order,
                           const float* __restrict__ weights,
                           float2* __restrict__ out, long long npoints, int n,
                           int m_runtime) {
  const int m = M ? M : m_runtime;
  const int taps = 2 * m;
  const int width = M ? group_width(2 * M) : group_width(taps);
  const int j = threadIdx.x & (width - 1);
  const long long point =
      (static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x) / width;
  // Every lane runs the loops (the shuffles need them all); a group past
  // the end repeats the last point and stores nothing.
  const bool live = point < npoints;
  const long long p = live ? point : npoints - 1;
  const bool tap = j < taps;
  const int bin = __ldcs(bins + p);
  const int b2 = bin % n;
  const int b1 = (bin / n) % n;
  const int b0 = bin / n / n;
  const int s0 = wrap(b0 + 1 - m, n);
  const int s1 = wrap(b1 + 1 - m, n);
  const int g2 = wrap(wrap(b2 + 1 - m, n) + (tap ? j : 0), n);
  // weights[axis][tap][point]: lane j reads tap j of each axis.
  const float w0 = tap ? __ldcs(weights + j * npoints + p) : 0.0f;
  const float w1 = tap ? __ldcs(weights + (taps + j) * npoints + p) : 0.0f;
  const float w2 = tap ? __ldcs(weights + (2 * taps + j) * npoints + p) : 0.0f;
  // This lane's column of the grid: cell g2 of every row.
  const float2* __restrict__ column = grid + g2;
  float2 acc = make_float2(0.0f, 0.0f);
  if constexpr (M > 0) {
    float w1r[2 * M];
    int r1[2 * M];
#pragma unroll
    for (int k = 0; k < 2 * M; ++k) {
      w1r[k] = __shfl_sync(kFullWarp, w1, k, width);
      r1[k] = s1 + k >= n ? s1 + k - n : s1 + k;
    }
#pragma unroll kGatherUnroll0
    for (int j0 = 0; j0 < 2 * M; ++j0) {
      const float w0j = __shfl_sync(kFullWarp, w0, j0, width);
      const int g0n = (s0 + j0 >= n ? s0 + j0 - n : s0 + j0) * n;
      float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j1 = 0; j1 < 2 * M; ++j1) {
        const float2 v = __ldg(column + static_cast<long long>(g0n + r1[j1]) * n);
        s.x = fmaf(w1r[j1], v.x, s.x);
        s.y = fmaf(w1r[j1], v.y, s.y);
      }
      acc.x = fmaf(w0j, s.x, acc.x);
      acc.y = fmaf(w0j, s.y, acc.y);
    }
  } else {
#pragma unroll 1
    for (int j0 = 0; j0 < taps; ++j0) {
      const float w0j = __shfl_sync(kFullWarp, w0, j0, width);
      const int g0n = wrap(s0 + j0, n) * n;
      float2 s = make_float2(0.0f, 0.0f);
#pragma unroll 1
      for (int j1 = 0; j1 < taps; ++j1) {
        const float w1j = __shfl_sync(kFullWarp, w1, j1, width);
        float2 v = make_float2(0.0f, 0.0f);
        if (tap) v = __ldg(column + static_cast<long long>(g0n + wrap(s1 + j1, n)) * n);
        s.x = fmaf(w1j, v.x, s.x);
        s.y = fmaf(w1j, v.y, s.y);
      }
      acc.x = fmaf(w0j, s.x, acc.x);
      acc.y = fmaf(w0j, s.y, acc.y);
    }
  }
  float2 t = make_float2(__fmul_rn(acc.x, w2), __fmul_rn(acc.y, w2));
  for (int offset = width / 2; offset > 0; offset >>= 1) {
    t.x += __shfl_xor_sync(kFullWarp, t.x, offset, width);
    t.y += __shfl_xor_sync(kFullWarp, t.y, offset, width);
  }
  if (live && j == 0) __stcs(out + __ldcs(order + p), t);
}

// A thread a point for m <= kThreadGatherMaxM: the point's weights in
// registers, its (2m)^3 taps unrolled, the sum factored with axis 2
// innermost, sum_j0 w0[j0] sum_j1 w1[j1] sum_j2 w2[j2] G[j0, j1, j2], in
// ascending order, written to out[order[p]].
template <int M>
__global__ void __launch_bounds__(kThreadGatherThreads)
    gaussian_gather_thread_kernel(const float2* __restrict__ grid,
                                  const int* __restrict__ bins,
                                  const int* __restrict__ order,
                                  const float* __restrict__ weights,
                                  float2* __restrict__ out, long long npoints, int n) {
  constexpr int kTaps = 2 * M;
  const long long p = static_cast<long long>(blockIdx.x) * kThreadGatherThreads + threadIdx.x;
  if (p >= npoints) return;
  const int bin = __ldcs(bins + p);
  const int b2 = bin % n;
  const int b1 = (bin / n) % n;
  const int b0 = bin / n / n;
  const int s0 = wrap(b0 + 1 - M, n);
  const int s1 = wrap(b1 + 1 - M, n);
  const int s2 = wrap(b2 + 1 - M, n);
  const float* __restrict__ w = weights + p;
  float w0[kTaps], w1[kTaps], w2[kTaps];
  int g1[kTaps], g2[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    w0[k] = __ldcs(w + k * npoints);
    w1[k] = __ldcs(w + (kTaps + k) * npoints);
    w2[k] = __ldcs(w + (2 * kTaps + k) * npoints);
    g1[k] = s1 + k >= n ? s1 + k - n : s1 + k;
    g2[k] = s2 + k >= n ? s2 + k - n : s2 + k;
  }
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int j0 = 0; j0 < kTaps; ++j0) {
    const int g0n = (s0 + j0 >= n ? s0 + j0 - n : s0 + j0) * n;
    float2 sum1 = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j1 = 0; j1 < kTaps; ++j1) {
      const float2* __restrict__ row = grid + static_cast<long long>(g0n + g1[j1]) * n;
      float2 sum2 = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j2 = 0; j2 < kTaps; ++j2) {
        const float2 v = __ldg(row + g2[j2]);
        sum2.x = fmaf(w2[j2], v.x, sum2.x);
        sum2.y = fmaf(w2[j2], v.y, sum2.y);
      }
      sum1.x = fmaf(w1[j1], sum2.x, sum1.x);
      sum1.y = fmaf(w1[j1], sum2.y, sum1.y);
    }
    acc.x = fmaf(w0[j0], sum1.x, acc.x);
    acc.y = fmaf(w0[j0], sum1.y, acc.y);
  }
  __stcs(out + __ldcs(order + p), acc);
}

// A chunk of a row of bins, one sorted point a lane, as a scatter warp holds
// it between its loads and its additions.
template <int M>
struct Chunk {
  int p;       // the point's place in the sorted list
  int b2;      // its base cell along axis 2; lanes past the run's end get
               // one of their own (negative)
  bool valid;
  float2 u;    // w0[j0] v, j0 the row of bins' axis-0 tap
  float w1[band_rows(M)];   // w1[j1] of each band row t1 the row of bins
                            // reaches (j1 = t1 - h1 + 2m - 1), else 0
  float w2[M ? 2 * M : 1];  // its axis-2 factors (M > 0)
};

// The scatter's work for one band is a list of items: the 32-point chunks
// of the (up to 32) rows of bins whose starts and ends, taps j0 and places
// h1 along axis 1 the lanes hold in my_first, my_last, my_j0 and my_h1
// (chunks_through: the chunks of rows 0 ... lane). Loads the points of item
// (< the rows' chunks in all), one a lane, and the h1 of its row.
template <int M>
__device__ __forceinline__ Chunk<M> load_chunk(
    int item, int chunks_through, int my_chunks, int my_bin, int my_first, int my_last,
    int my_j0, int my_h1, int lane, int taps, int rows, long long npoints,
    const float2* __restrict__ values, const int* __restrict__ bins,
    const int* __restrict__ order, const float* __restrict__ weights, int* h1) {
  constexpr int kRows = band_rows(M);
  Chunk<M> c;
  c.b2 = -1 - lane;
  c.u = make_float2(0.0f, 0.0f);
  // The row of bins this item lies in: the first whose chunks reach it.
  const int k = __ffs(__ballot_sync(kFullWarp, chunks_through > item)) - 1;
  const int row_bin = __shfl_sync(kFullWarp, my_bin, k);
  const int last = __shfl_sync(kFullWarp, my_last, k);
  const int chunk = item - __shfl_sync(kFullWarp, chunks_through - my_chunks, k);
  const int j0 = __shfl_sync(kFullWarp, my_j0, k);
  *h1 = __shfl_sync(kFullWarp, my_h1, k);
  c.p = __shfl_sync(kFullWarp, my_first, k) + 32 * chunk + lane;
  c.valid = c.p < last;
#pragma unroll
  for (int t1 = 0; t1 < kRows; ++t1) c.w1[t1] = 0.0f;
  if (c.valid) {
    const float* __restrict__ w = weights + c.p;
    c.b2 = __ldg(bins + c.p) - row_bin;
    const float2 v = __ldg(values + __ldg(order + c.p));
    const float w0 = __ldg(w + j0 * npoints);
    c.u = make_float2(__fmul_rn(w0, v.x), __fmul_rn(w0, v.y));
#pragma unroll
    for (int t1 = 0; t1 < kRows; ++t1) {
      const int j1 = t1 - *h1 + taps - 1;
      if (t1 < rows && j1 >= 0 && j1 < taps) c.w1[t1] = __ldg(w + (taps + j1) * npoints);
    }
    if constexpr (M > 0) {
#pragma unroll
      for (int j2 = 0; j2 < 2 * M; ++j2) c.w2[j2] = __ldg(w + (2 * taps + j2) * npoints);
    }
  }
  return c;
}

// Adds a chunk's terms w1 (w2 (w0 v)) to the warp's copy of the band, acc
// (rows of stride cells), for each tap j2 in turn and each band row t1 the
// row of bins at walk place h1 reaches. The chunk's base cells b2 ascend,
// so lanes with equal b2 are neighbours: a segmented sum by shuffles leaves
// each segment's total in its last lane, which adds it to cell b2 + 1 - m +
// j2 of the row; no two segments share a base cell, so no two lanes add to
// one cell in one step.
template <int M>
__device__ __forceinline__ void add_chunk(const Chunk<M>& c, int h1, float2* __restrict__ acc,
                                          int stride, int lane, int m, int n, int rows,
                                          const float* __restrict__ weights, long long npoints) {
  constexpr int kRows = band_rows(M);
  const int taps = 2 * m;
  // The lanes that start a segment of equal b2, each lane's distance from
  // its segment's start, the longest segment, and the segments' last lanes.
  const int up = __shfl_up_sync(kFullWarp, c.b2, 1);
  const unsigned heads = __ballot_sync(kFullWarp, lane == 0 || up != c.b2);
  const int dist = lane - (31 - __clz(heads & (kFullWarp >> (31 - lane))));
  const int longest = __reduce_max_sync(kFullWarp, dist);
  const bool is_tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  // The band rows this row of bins reaches: t1 = h1 - 2m + 1 ... h1.
  const int t_lo = max(0, h1 - taps + 1);
  const int t_hi = min(rows - 1, h1);
  constexpr int kUnroll = M ? 2 * M : 1;
#pragma unroll kUnroll
  for (int j2 = 0; j2 < taps; ++j2) {
    float2 wu = make_float2(0.0f, 0.0f);
    if (c.valid) {
      float w2j;
      if constexpr (M > 0) w2j = c.w2[j2];
      else w2j = __ldg(weights + (2 * taps + j2) * npoints + c.p);
      wu = make_float2(__fmul_rn(w2j, c.u.x), __fmul_rn(w2j, c.u.y));
    }
    const int cell = wrap(c.b2 + 1 - m + j2, n);
#pragma unroll
    for (int t1 = 0; t1 < kRows; ++t1) {
      if (t1 < t_lo || t1 > t_hi) continue;
      float2 t = make_float2(__fmul_rn(c.w1[t1], wu.x), __fmul_rn(c.w1[t1], wu.y));
      // Inclusive sums within each segment, in a fixed order.
      for (int d = 1; d <= longest; d <<= 1) {
        const float x = __shfl_up_sync(kFullWarp, t.x, d);
        const float y = __shfl_up_sync(kFullWarp, t.y, d);
        if (dist >= d) {
          t.x += x;
          t.y += y;
        }
      }
      if (c.valid && is_tail) {
        float2* at = acc + t1 * stride + cell;
        float2 sum = *at;
        sum.x += t.x;
        sum.y += t.y;
        *at = sum;
      }
    }
    __syncwarp();
  }
}

template <int M>
__global__ void __launch_bounds__(32 * kScatterWarps)
    gaussian_scatter_kernel(const float2* __restrict__ values,
                            const int* __restrict__ bins,
                            const int* __restrict__ order,
                            const int* __restrict__ bin_start,
                            const float* __restrict__ weights,
                            const int2* __restrict__ block_table,
                            float2* __restrict__ grid, long long npoints, int n,
                            int m_runtime) {
  extern __shared__ float2 band[];
  constexpr int kRows = band_rows(M);
  const int m = M ? M : m_runtime;
  const int taps = 2 * m;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // The band: rows c1 ... c1 + rows - 1 of plane c0.
  const int2 entry = __ldg(block_table + blockIdx.x);
  const int c0 = entry.x / n;
  const int c1 = entry.x % n;
  const int rows = entry.y;
  // Each warp's copy of the band, kRows rows of n cells.
  float2* __restrict__ acc = band + warp * kRows * n;
  for (int c = lane; c < kRows * n; c += 32) acc[c] = make_float2(0.0f, 0.0f);
  __syncwarp();
  // The rows of bins that reach the band, axis-0 tap j0 outermost, then
  // their place h1 along axis 1, up to 32 at a time: lane k reads where row
  // k starts and ends in the sorted list. Their points, 32 to a chunk, are
  // the items of work, dealt to the block's warps in turn.
  const int span1 = rows + taps - 1;
  const int walk = taps * span1;
  for (int first_row = 0; first_row < walk; first_row += 32) {
    int my_bin = 0, my_first = 0, my_last = 0, my_j0 = 0, my_h1 = 0;
    if (first_row + lane < walk) {
      my_j0 = (first_row + lane) / span1;
      my_h1 = (first_row + lane) - my_j0 * span1;
      my_bin = (wrap(c0 + m - 1 - my_j0, n) * n + wrap(c1 - m + my_h1, n)) * n;
      my_first = __ldg(bin_start + my_bin);
      my_last = __ldg(bin_start + my_bin + n);
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
      int h1;
      const Chunk<M> c = load_chunk<M>(item, chunks_through, my_chunks, my_bin, my_first,
                                       my_last, my_j0, my_h1, lane, taps, rows, npoints,
                                       values, bins, order, weights, &h1);
      add_chunk<M>(c, h1, acc, n, lane, m, n, rows, weights, npoints);
    }
  }
  __syncthreads();
  // The band: the warps' copies added in the warps' order, each value
  // written once.
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    float2 sum = band[i];
#pragma unroll
    for (int w = 1; w < kScatterWarps; ++w) {
      const float2 more = band[w * kRows * n + i];
      sum.x += more.x;
      sum.y += more.y;
    }
    grid[(static_cast<long long>(c0) * n + c1) * n + i] = sum;
  }
}

bool valid(int n, int m) {
  return m >= 1 && 2 * m <= n && 2 * m <= kMaxTaps && n <= kMaxN;
}

template <int M>
cudaError_t launch_gather(const void* grid, const int* bins, const int* order,
                          const float* weights, void* out, long long npoints,
                          int n, int m, cudaStream_t stream) {
  if constexpr (M > 0 && M <= kThreadGatherMaxM) {
    const long long blocks = (npoints + kThreadGatherThreads - 1) / kThreadGatherThreads;
    gaussian_gather_thread_kernel<M><<<static_cast<unsigned>(blocks), kThreadGatherThreads, 0,
                                       stream>>>(static_cast<const float2*>(grid), bins,
                                                 order, weights,
                                                 static_cast<float2*>(out), npoints, n);
    return cudaGetLastError();
  }
  const long long threads = npoints * group_width(2 * m);
  const long long blocks = (threads + kGatherThreads - 1) / kGatherThreads;
  gaussian_gather_kernel<M><<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                              stream>>>(static_cast<const float2*>(grid), bins,
                                        order, weights,
                                        static_cast<float2*>(out), npoints, n, m);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_scatter(const void* values, const int* bins, const int* order,
                           const int* bin_start, const float* weights,
                           const int* block_table, int blocks, void* grid,
                           long long npoints, int n, int m, cudaStream_t stream) {
  // Each warp's copy of the band.
  const long long bytes = static_cast<long long>(kScatterWarps) * band_rows(M) * n * 8;
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  // Above 48 KB a block asks for its shared memory: once a device.
  if (bytes > 48 * 1024) {
    static bool opted[64] = {};
    int device = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc != cudaSuccess) return rc;
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!opted[device]) {
      rc = cudaFuncSetAttribute(gaussian_scatter_kernel<M>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
      if (rc != cudaSuccess) return rc;
      opted[device] = true;
    }
  }
  gaussian_scatter_kernel<M><<<static_cast<unsigned>(blocks), 32 * kScatterWarps,
                               static_cast<size_t>(bytes), stream>>>(
      static_cast<const float2*>(values), bins, order, bin_start, weights,
      reinterpret_cast<const int2*>(block_table), static_cast<float2*>(grid), npoints, n, m);
  return cudaGetLastError();
}

}  // namespace

// out (npoints) complex64 = the grid (n^3 complex64, centred) interpolated
// at the points of a Gaussian plan (bins, order: npoints int32; weights:
// 3 x 2m x npoints float32) with the 2m-tap window.
extern "C" int tike_gaussian_gather(const void* grid, const void* bins,
                                    const void* order, const void* weights,
                                    void* out, long long npoints, int n, int m,
                                    void* stream) {
  if (!valid(n, m) || npoints < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (npoints == 0) return static_cast<int>(cudaGetLastError());
  const int* b = static_cast<const int*>(bins);
  const int* o = static_cast<const int*>(order);
  const float* w = static_cast<const float*>(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch_gather<1>(grid, b, o, w, out, npoints, n, m, s));
    case 2: return static_cast<int>(launch_gather<2>(grid, b, o, w, out, npoints, n, m, s));
    case 3: return static_cast<int>(launch_gather<3>(grid, b, o, w, out, npoints, n, m, s));
    case 4: return static_cast<int>(launch_gather<4>(grid, b, o, w, out, npoints, n, m, s));
    case 6: return static_cast<int>(launch_gather<6>(grid, b, o, w, out, npoints, n, m, s));
    default: return static_cast<int>(launch_gather<0>(grid, b, o, w, out, npoints, n, m, s));
  }
}

// grid (n^3 complex64), every value written = the values (npoints complex64,
// in the caller's order) spread at the points of a Gaussian plan (as above,
// and bin_start: n^3 + 1 int32) by the bands of block_table (blocks pairs
// (c0 n + c1, rows): rows 1 ... band_rows(m) rows of plane c0 from row c1,
// covering the grid once, launched in the table's order); the adjoint of
// tike_gaussian_gather.
extern "C" int tike_gaussian_scatter(const void* values, const void* bins,
                                     const void* order, const void* bin_start,
                                     const void* weights, const void* block_table,
                                     int blocks, void* grid, long long npoints, int n,
                                     int m, void* stream) {
  if (!valid(n, m) || npoints < 0 || !block_table || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* b = static_cast<const int*>(bins);
  const int* o = static_cast<const int*>(order);
  const int* bs = static_cast<const int*>(bin_start);
  const float* w = static_cast<const float*>(weights);
  const int* t = static_cast<const int*>(block_table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch_scatter<1>(values, b, o, bs, w, t, blocks, grid, npoints, n, m, s));
    case 2: return static_cast<int>(launch_scatter<2>(values, b, o, bs, w, t, blocks, grid, npoints, n, m, s));
    case 4: return static_cast<int>(launch_scatter<4>(values, b, o, bs, w, t, blocks, grid, npoints, n, m, s));
    default: return static_cast<int>(launch_scatter<0>(values, b, o, bs, w, t, blocks, grid, npoints, n, m, s));
  }
}

// Lanczos-windowed 2D resampling (remap) and its adjoint for NVIDIA Hopper,
// built for sm_90a with nvcc into a shared library with a plain C interface
// (loaded by tike_tpu_torch/kernels.py through ctypes).
//
// What they replace. The JAX package computes the pair with XLA code
// (tike_tpu/ops/interp.py): remap_lanczos_fwd (:36-68) is a lax.scan over
// the (2m+1)^2 taps, each a gather of every point's tap, and
// remap_lanczos_adj (:71-102) the same scan of scatter-adds. The original
// tike ran them as the CUDA kernels fwd_lanczos_interp2D and
// adj_lanczos_interp2D (interp.cu:218-237). Here:
//   - remap_lanczos_fwd -> lanczos_fwd_kernel;
//   - remap_lanczos_adj -> lanczos_adj_kernel.
// Semantics are tike_tpu's: a point (y, x) takes the taps floor(y) - m ..
// floor(y) + m by floor(x) - m .. floor(x) + m, each weighted by
// L(y - row) L(x - col), L the 2-lobe Lanczos window with its 1e-12 guards
// and 0 beyond |d| > 2 (_lanczos_weight, :21-27); a forward tap outside
// the grid adds cval times its weight, an adjoint tap outside is dropped.
// csrc/interp_first_form.cu keeps these kernels' first form as a yardstick.
//
// The window every m >= 2 reduces to. With f = c - floor(c) in [0, 1), the
// tap at offset o from floor(c) has d = f - o. The window is 0 for |d| > 2
// (tike_tpu/ops/interp.py:27), so the offsets beyond -2 .. 2 that m > 2
// adds weigh exactly 0, and the offset -2 (d = f + 2) is inside only at
// f = 0, where its weight 2 sin(2 pi) sin(pi) / (2 pi)^2 is 0 (about 1e-15
// in float32). So every m >= 2 computes the 4 x 4 window at offsets -1 .. 2
// on each axis; m = 1 keeps its 3 taps (-1 .. 1) and m = 0 its one. The
// kernels compile these three windows (K = 1, 3, 4 taps a side); the
// first form's run-time-m loop did 121 taps at m = 5 and 529 at m = 11
// for m = 2's result.
//
// Two sines an axis. sin(pi (f - o)) = (-1)^o sin(pi f), and sin(pi (f -
// o) / 2) cycles through cos, sin, -cos, -sin of pi f / 2 as o goes -1, 0,
// 1, 2; with sin(pi f) = 2 sin(pi f / 2) cos(pi f / 2), every weight of an
// axis is (4 / pi^2) s c (c, s, c, s) (-, +, +, -) / d^2, from one
// sincospif(f / 2) (s, c) an axis: 2 sines a point where the first form
// took 20 accurate sinf (kSinePair = false restores those). d = 0 keeps its
// guard (weight 1); so does d = 0 at o = 1, where c - floor(c) rounds to 1
// for c just below an integer. The weights lie within about 2e-7 of the
// JAX package's (tests/_torch_interp_cases.py::sine_pair_weights mirrors
// them).
//
// Layout. Images (I, H, W) and values (I, N) are complex64 seen as float2
// (torch.view_as_real) or float32: T is float2 or float. Points are (I, N,
// 2) float32 (y, x), one set per image (flow), or one (N, 2) set that every
// image shares (rotate: shared_points = 1, a point stride of 0). One launch
// covers every image: blockIdx.y is the image, x the points.
//
// What bounds them on this card. At the paths' shapes (I = 128 images of
// 1024^2, m = 2) each must move the image stack once, the points once and
// the values once (ops/interp.py, roofline): 3.2 GB with a point set per
// image, 0.96 ms at 3.35 TB/s (2.16 GB, 0.64 ms, with the rotation's
// shared points). The least arithmetic is two sine pairs and 8 weights a
// point and, summed row by row, 16 + 4 multiply-adds a channel: 80 FP32
// instructions a point, 0.32 ms. Both are bound by bytes.
//
// lanczos_fwd_kernel. One thread per (image, point): its 2K one-axis
// weights in registers, the taps summed row by row in float32 (a row's sum
// of wx[j] v times wy[i]; the XLA code multiplies every tap by wy[i] wx[j]),
// read through the read-only cache: neighbouring points of a warp read
// neighbouring pixels, so the K^2 reads a point makes are mostly L1 hits. A
// window wholly inside the grid takes the loads without bounds checks.
//
// Measured (python -m tike_tpu_torch.kernel_sweep --source interp; an H100
// 80GB HBM3 at 700 W; CUDA graphs; 128 x 1024^2 complex64, m = 2, the
// flow's points / the rotation's): the forward 1.381 / 1.265 ms, its first
// form 5.312 / 5.300. Its weights from 20 accurate sinf took 3.420 / 3.393,
// and their quotients by __fdividef (whose range fix-ups are some 15
// instructions each) 1.460 / 1.353. Reading one tap a row in place of four
// took 1.277 / 1.148 ms: the tap loads are a tenth of its time, not what
// binds it, so it stages no tiles in shared memory. The adjoint (a) 3.720 /
// 4.086 ms (with the wrapper's zeroing of the grid), its first form 11.226
// / 12.272; adding nothing to the grid 3.606 / 3.915, so its REDs cost a
// few percent and its buffer steps the rest; buffers of 6 x 40 and 8 x 64
// cells within 5%; every warp tap by tap 14.956 / 15.806 while the fallback's
// count was one address every warp added to; the lowest of two peers adding
// both lanes' taps, read by shuffles, in place of a second turn: 2% slower
// (an earlier sweep). A second adjoint, form (b), an owned gather in the
// manner of csrc/usfft.cu's kb_scatter_kernel (a block a grid row, from a
// stable sort of the points by window origin; no atomics, bitwise
// repeatable), took 6.926 / 6.923 ms on a plan built beforehand and the plan
// 26.2 / 0.48 ms: slower than (a) at both, so it was taken out. A rotation
// by 0.5 rad spreads every warp's windows over more rows than the buffer
// holds: (a) then adds tap by tap, 18.09 ms (first form 28.23), where (b)
// took 5.64 ms and its plan 0.31.
//
// lanczos_adj_kernel, form (a): warp-aggregated windows. A warp's 32 points
// (consecutive points of one image) spread into a buffer of the warp's own
// in shared memory, kBufRows x kBufCols cells over the bounding box of the
// lanes' windows, then the warp adds each cell of the box it touched to
// the grid with one float (float2 for complex: one vector RED on sm_90)
// global atomic. Lanes whose windows share an origin take turns (ranked by
// __match_any_sync), every other lane adds to distinct cells in each tap
// step, so the buffer needs no atomics. A flow's or a small rotation's
// warp covers one to three rows of origins and about 36 columns: about
// (rows + 3) 36 / 32 REDs a point instead of the first form's 25 (16 at K
// = 4). A warp whose box does not fit adds tap by tap to the grid, as the
// first form did, and adds one to the card's counter (a slot of fallback). The grid
// is zeroed by the wrapper first. The REDs of neighbouring warps meet in
// no fixed order, so the last bits vary from run to run.
//
// Each launcher allocates nothing, launches on the stream it is given and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
// The adjoint: the cells of a warp's buffer, rows by columns of the grid.
constexpr int kBufRows = 8;
constexpr int kBufCols = 40;
// The adjoint: the fallback count is spread over this many 64-bit slots, so
// warps that fall back do not all add to one address.
constexpr int kFallbackSlots = 256;
// false: every warp adds tap by tap to the grid (the first form's atomics,
// on the 4 x 4 window).
constexpr bool kWarpAggregate = true;
// false: each weight from two accurate sinf, as the first form.
constexpr bool kSinePair = true;

constexpr float kFourOverPiSq = 0.405284734569351086f;

// Taps a side of the window that half-width m computes: offsets kLo ..
// kLo + K - 1 from floor(c).
__host__ __device__ constexpr int window_taps(int m) { return m == 0 ? 1 : m == 1 ? 3 : 4; }
template <int K>
constexpr int kLo = K == 1 ? 0 : -1;

// tike_tpu/ops/interp.py::_lanczos_weight with nlobes = 2, in its order of
// float32 operations (kSinePair = false).
__device__ __forceinline__ float lanczos(float d) {
  const float pix = d * 3.14159265358979f;
  const float safe = fabsf(pix) < 1e-12f ? 1.0f : pix;
  const float num = (2.0f * sinf(safe)) * sinf(safe / 2.0f);
  const float w = fabsf(d) < 1e-12f ? 1.0f : num / (safe * safe);
  return fabsf(d) <= 2.0f ? w : 0.0f;
}

// The axis's sine pair: (4 / pi^2) s c times c (odd o) and s (even o),
// s, c = sin, cos(pi f / 2).
struct SinePair {
  float odd, even;
};

__device__ __forceinline__ SinePair sine_pair(float f) {
  float s, c;
  sincospif(0.5f * f, &s, &c);
  const float sc = kFourOverPiSq * s * c;
  return {sc * c, sc * s};
}

// 1 / x, the approximate reciprocal (one MUFU.RCP, within an ulp); x is
// at least 1e-24 here, a normal float.
__device__ __forceinline__ float reciprocal(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The weight of offset o (-1 .. 2) at fraction f in [0, 1]. Only o = 0 and
// o = 1 can meet d = 0 (at f = 0 and f = 1), so only they keep the guard.
__device__ __forceinline__ float tap_weight(SinePair sp, float f, int o) {
  const float d = f - static_cast<float>(o);
  const float num = o == -1 ? -sp.odd : o == 0 ? sp.even : o == 1 ? sp.odd : -sp.even;
  const float w = num * reciprocal(d * d);
  return (o == 0 || o == 1) && fabsf(d) < 1e-12f ? 1.0f : w;
}

// The one-axis weights of a point: w[i] = L(c - (floor(c) + kLo + i));
// returns floor(c) + kLo, the window's first row or column.
template <int K>
__device__ __forceinline__ int axis_weights(float c, float (&w)[K]) {
  const float fl = floorf(c);
  const float f = c - fl;
  if constexpr (kSinePair) {
    const SinePair sp = sine_pair(f);
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = tap_weight(sp, f, kLo<K> + i);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = lanczos(c - (fl + static_cast<float>(kLo<K> + i)));
  }
  return static_cast<int>(fl) + kLo<K>;
}

__device__ __forceinline__ float scale_add(float w, float v, float acc) {
  return fmaf(w, v, acc);
}

__device__ __forceinline__ float2 scale_add(float w, float2 v, float2 acc) {
  return make_float2(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y));
}

__device__ __forceinline__ float scale(float w, float v) { return w * v; }

__device__ __forceinline__ float2 scale(float w, float2 v) {
  return make_float2(w * v.x, w * v.y);
}

__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }

__device__ __forceinline__ bool nonzero(float2 v) { return v.x != 0.0f || v.y != 0.0f; }

template <typename T>
__device__ __forceinline__ T zero_value();

template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ float2 zero_value<float2>() {
  return make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ void atomic_add(float* address, float v) {
  atomicAdd(address, v);
}

__device__ __forceinline__ void atomic_add(float2* address, float2 v) {
  atomicAdd(address, v);  // sm_90: one vector RED to global memory
}

// The sum of a point's K x K taps, row by row: sum_i wy[i] (sum_j wx[j]
// v[i, j]); Checked: taps outside the grid read cval.
template <int K, bool Checked, typename T>
__device__ __forceinline__ T window_sum(const T* __restrict__ im, int row0, int col0,
                                        int h, int w, const float (&wy)[K],
                                        const float (&wx)[K], T cval) {
  T acc = zero_value<T>();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int row = row0 + i;
    const T* line = im + static_cast<long long>(row) * w + col0;
    T sum = zero_value<T>();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      T v;
      if constexpr (Checked) {
        const int col = col0 + j;
        v = (row >= 0 && row < h && col >= 0 && col < w) ? __ldg(line + j) : cval;
      } else {
        v = __ldg(line + j);
      }
      sum = scale_add(wx[j], v, sum);
    }
    acc = scale_add(wy[i], sum, acc);
  }
  return acc;
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
    lanczos_fwd_kernel(const T* __restrict__ image,
                       const float2* __restrict__ points, T* __restrict__ out,
                       long long npoints, int h, int w, int shared_points, T cval) {
  const long long p = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (p >= npoints) return;
  const long long img = blockIdx.y;
  const float2 pt = __ldg(points + (shared_points ? 0 : img * npoints) + p);
  const T* im = image + img * h * w;
  float wy[K], wx[K];
  const int row0 = axis_weights(pt.x, wy);
  const int col0 = axis_weights(pt.y, wx);
  const bool inside = row0 >= 0 && row0 <= h - K && col0 >= 0 && col0 <= w - K;
  out[img * npoints + p] = inside ? window_sum<K, false>(im, row0, col0, h, w, wy, wx, cval)
                                  : window_sum<K, true>(im, row0, col0, h, w, wy, wx, cval);
}

// A point's K x K taps added to the grid one global atomic each, taps
// outside dropped.
template <int K, typename T>
__device__ __forceinline__ void spread_taps(T* g, int row0, int col0, int h, int w,
                                            const float (&wy)[K], const float (&wx)[K], T v) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int row = row0 + i;
    if (row < 0 || row >= h) continue;
    const T rv = scale(wy[i], v);
    T* line = g + static_cast<long long>(row) * w;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int col = col0 + j;
      if (col >= 0 && col < w) atomic_add(line + col, scale(wx[j], rv));
    }
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
    lanczos_adj_kernel(const T* __restrict__ values,
                       const float2* __restrict__ points, T* __restrict__ grid,
                       unsigned long long* __restrict__ fallback, long long npoints,
                       int h, int w, int shared_points) {
  __shared__ T buffers[kThreads / 32][kBufRows * kBufCols];
  const int lane = threadIdx.x & 31;
  const long long first = blockIdx.x * static_cast<long long>(kThreads) + (threadIdx.x & ~31);
  if (first >= npoints) return;  // the whole warp
  const long long p = first + lane;
  const bool valid = p < npoints;
  const long long img = blockIdx.y;
  const float2 pt =
      valid ? __ldg(points + (shared_points ? 0 : img * npoints) + p) : make_float2(0.0f, 0.0f);
  const T v = valid ? __ldg(values + img * npoints + p) : zero_value<T>();
  T* g = grid + img * h * w;
  float wy[K], wx[K];
  const int row0 = axis_weights(pt.x, wy);
  const int col0 = axis_weights(pt.y, wx);
  // The bounding box of the warp's window origins.
  const unsigned all = 0xffffffffu;
  const int rmin = __reduce_min_sync(all, valid ? row0 : INT_MAX);
  const int rmax = __reduce_max_sync(all, valid ? row0 : INT_MIN);
  const int cmin = __reduce_min_sync(all, valid ? col0 : INT_MAX);
  const int cmax = __reduce_max_sync(all, valid ? col0 : INT_MIN);
  const long long rows = static_cast<long long>(rmax) - rmin + K;
  const long long cols = static_cast<long long>(cmax) - cmin + K;
  if (!kWarpAggregate || rows > kBufRows || cols > kBufCols) {
    if (lane == 0) atomicAdd(fallback + blockIdx.x % kFallbackSlots, 1ull);
    if (valid) spread_taps(g, row0, col0, h, w, wy, wx, v);
    return;
  }
  T* buf = buffers[threadIdx.x >> 5];
  const int box_rows = static_cast<int>(rows), box_cols = static_cast<int>(cols);
  for (int r = 0; r < box_rows; ++r) {
    for (int c = lane; c < box_cols; c += 32) buf[r * kBufCols + c] = zero_value<T>();
  }
  // Lanes whose windows share an origin take turns; in each turn and tap
  // step the lanes' cells are distinct.
  const int origin = valid ? (row0 - rmin) * kBufCols + (col0 - cmin) : -1 - lane;
  const unsigned peers = __match_any_sync(all, origin);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int turns = __reduce_max_sync(all, static_cast<unsigned>(rank)) + 1;
  __syncwarp();
  for (int turn = 0; turn < turns; ++turn) {
    const bool mine = valid && rank == turn;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T rv = scale(wy[i], v);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (mine) {
          T* cell = buf + origin + i * kBufCols + j;
          *cell = scale_add(wx[j], rv, *cell);
        }
        __syncwarp();
      }
    }
  }
  // One atomic a touched cell of the box inside the grid.
  for (int r = 0; r < box_rows; ++r) {
    const int row = rmin + r;
    if (row < 0 || row >= h) continue;
    T* line = g + static_cast<long long>(row) * w;
    for (int c = lane; c < box_cols; c += 32) {
      const int col = cmin + c;
      const T sum = buf[r * kBufCols + c];
      if (col >= 0 && col < w && nonzero(sum)) atomic_add(line + col, sum);
    }
  }
}

dim3 grid_of(int images, long long npoints) {
  return dim3(static_cast<unsigned>((npoints + kThreads - 1) / kThreads),
              static_cast<unsigned>(images));
}

bool valid(int images, long long npoints, int h, int w, int m) {
  return images >= 1 && images <= 65535 && npoints >= 0 && h >= 1 && w >= 1 &&
         m >= 0 && m < (1 << 29) &&
         (npoints + kThreads - 1) / kThreads <= 2147483647LL;
}

template <typename T>
cudaError_t launch_fwd(const T* image, const float2* points, T* out,
                       int images, long long npoints, int h, int w, int m,
                       int shared, T cval, cudaStream_t s) {
  if (!valid(images, npoints, h, w, m)) return cudaErrorInvalidValue;
  if (npoints == 0) return cudaSuccess;
  const dim3 grid = grid_of(images, npoints);
  switch (window_taps(m)) {
    case 1:
      lanczos_fwd_kernel<1, T><<<grid, kThreads, 0, s>>>(image, points, out, npoints, h, w,
                                                         shared, cval);
      break;
    case 3:
      lanczos_fwd_kernel<3, T><<<grid, kThreads, 0, s>>>(image, points, out, npoints, h, w,
                                                         shared, cval);
      break;
    default:
      lanczos_fwd_kernel<4, T><<<grid, kThreads, 0, s>>>(image, points, out, npoints, h, w,
                                                         shared, cval);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_adj(const T* values, const float2* points, T* grid_out,
                       unsigned long long* fallback, int images, long long npoints, int h,
                       int w, int m, int shared, cudaStream_t s) {
  if (!valid(images, npoints, h, w, m) || fallback == nullptr) return cudaErrorInvalidValue;
  if (npoints == 0) return cudaSuccess;
  const dim3 grid = grid_of(images, npoints);
  switch (window_taps(m)) {
    case 1:
      lanczos_adj_kernel<1, T><<<grid, kThreads, 0, s>>>(values, points, grid_out, fallback,
                                                         npoints, h, w, shared);
      break;
    case 3:
      lanczos_adj_kernel<3, T><<<grid, kThreads, 0, s>>>(values, points, grid_out, fallback,
                                                         npoints, h, w, shared);
      break;
    default:
      lanczos_adj_kernel<4, T><<<grid, kThreads, 0, s>>>(values, points, grid_out, fallback,
                                                         npoints, h, w, shared);
  }
  return cudaGetLastError();
}

}  // namespace

// image (I, H, W), points (I, N, 2) or shared (N, 2), out (I, N); channels
// 2 for complex64, 1 for float32 (cval_im is then ignored).
extern "C" int tike_lanczos_fwd(const void* image, const void* points, void* out,
                                int images, long long npoints, int h, int w,
                                int m, int shared_points, int channels,
                                float cval_re, float cval_im, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pts = static_cast<const float2*>(points);
  cudaError_t err;
  if (channels == 2) {
    err = launch_fwd(static_cast<const float2*>(image), pts, static_cast<float2*>(out),
                     images, npoints, h, w, m, shared_points,
                     make_float2(cval_re, cval_im), s);
  } else if (channels == 1) {
    err = launch_fwd(static_cast<const float*>(image), pts, static_cast<float*>(out),
                     images, npoints, h, w, m, shared_points, cval_re, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// values (I, N), points as above, grid (I, H, W) zeroed by the
// caller; fallback, kFallbackSlots unsigned 64-bit counts on the card, whose
// sum gains one for each warp that added tap by tap.
extern "C" int tike_lanczos_adj(const void* values, const void* points, void* grid,
                                void* fallback, int images, long long npoints, int h,
                                int w, int m, int shared_points, int channels,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pts = static_cast<const float2*>(points);
  auto* count = static_cast<unsigned long long*>(fallback);
  cudaError_t err;
  if (channels == 2) {
    err = launch_adj(static_cast<const float2*>(values), pts, static_cast<float2*>(grid), count,
                     images, npoints, h, w, m, shared_points, s);
  } else if (channels == 1) {
    err = launch_adj(static_cast<const float*>(values), pts, static_cast<float*>(grid), count,
                     images, npoints, h, w, m, shared_points, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

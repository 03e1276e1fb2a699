// The Lanczos remap pair in its first form, kept as a yardstick: the
// redesigned kernels of csrc/interp.cu are timed in turns with these. No path
// of the package runs them. Only the entry points are renamed
// (tike_lanczos_first_form_fwd/_adj); the text below is the first form's own.
//
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
//
// Layout. Images (I, H, W) and values (I, N) are complex64 seen as float2
// (torch.view_as_real) or float32: T is float2 or float. Points are (I, N,
// 2) float32 (y, x), one set per image (flow), or one (N, 2) set that every
// image shares (rotate: shared_points = 1, a point stride of 0). One launch
// covers every image: blockIdx.y is the image, x the point.
//
// What bounds them on this card. At the paths' shapes (I = 128 images of
// 1024^2, m = 2) each must move the image stack once, the points once and
// the values once (ops/interp.py, roofline): 3.2 GB with a point set per
// image, 0.96 ms at 3.35 TB/s (2.16 GB, 0.64 ms, with the rotation's
// shared points). The arithmetic is 2(2m+1) Lanczos weights a point (2
// sines each) and, summed row by row, (2m+1)^2 + (2m+1) multiply-adds a
// channel: 150 FP32 instructions a point at m = 2, 0.60 ms at 33.45e12 a
// second, so both are bound by bytes, near the balance of the two.
//
// lanczos_fwd_kernel. One thread per (image, point). The weights are
// separable, so the thread computes the 2(2m+1) one-axis weights once (10
// Lanczos evaluations at m = 2, where the XLA code evaluates 50), then sums
// the taps row by row in float32, each row's sum of wx[j] v times wy[i]
// (the XLA code multiplies every tap by wy[i] wx[j]), reading them through
// the read-only cache: neighbouring points of a warp read neighbouring pixels, so the
// (2m+1)^2 reads a point makes are mostly L1 hits. The result differs from
// the plain version only by rounding (sinf, the row sums and the fused
// multiply-adds).
//
// lanczos_adj_kernel. One thread per (image, point), the same weights,
// wy[i] v formed once a row, and one native global float atomic add of
// wx[j] (wy[i] v) a tap inside the grid (a float2
// atomic for complex values: one RED a tap on sm_90; only shared-memory
// float atomics are compare-and-swap loops there). The wrapper zeroes the
// grid first. The order of the adds varies from run to run, and so do the
// last bits of the result. An atomic-free form (points sorted by cell,
// blocks that own output tiles, as csrc/patch.cu's patch_adj_kernel and
// csrc/usfft.cu's kb_scatter_kernel do) is left for its redesign.
//
// m is a runtime argument of any size; m = 1 and 2, the paths' half-widths,
// have compiled tap counts and their weights in registers, other m compute
// each weight where it is used. Each launcher allocates nothing, launches on
// the stream it is given and returns a cudaError_t; the Python wrapper
// raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// tike_tpu/ops/interp.py::_lanczos_weight with nlobes = 2, in its order of
// float32 operations.
__device__ __forceinline__ float lanczos(float d) {
  const float pix = d * 3.14159265358979f;
  const float safe = fabsf(pix) < 1e-12f ? 1.0f : pix;
  const float num = (2.0f * sinf(safe)) * sinf(safe / 2.0f);
  const float w = fabsf(d) < 1e-12f ? 1.0f : num / (safe * safe);
  return fabsf(d) <= 2.0f ? w : 0.0f;
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

// The one-axis weights of a point: w[i] = L(c - (floor(c) + i - m)).
template <int kTaps>
__device__ __forceinline__ int axis_weights(float c, float (&w)[kTaps]) {
  const int base = static_cast<int>(floorf(c)) - kTaps / 2;
#pragma unroll
  for (int i = 0; i < kTaps; ++i) w[i] = lanczos(c - static_cast<float>(base + i));
  return base;
}

// The weights are separable, so a point's sum is taken row by row:
// sum_i wy[i] (sum_j wx[j] v[i, j]). M > 0: m = M at compile time, the
// 2(2m+1) one-axis weights computed once into registers. M = 0: m at run
// time, of any size, each weight computed where it is used (wx again for
// every row), so no array bounds m.
template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
    lanczos_fwd_kernel(const T* __restrict__ image,
                       const float2* __restrict__ points, T* __restrict__ out,
                       long long npoints, int h, int w, int m_run,
                       int shared_points, T cval) {
  const long long p = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (p >= npoints) return;
  const long long img = blockIdx.y;
  const float2 pt = __ldg(points + (shared_points ? 0 : img * npoints) + p);
  const T* im = image + img * h * w;
  // A tap's value, cval outside the grid.
  auto tap = [&](int row, int col) {
    return (row >= 0 && row < h && col >= 0 && col < w)
               ? __ldg(im + static_cast<long long>(row) * w + col)
               : cval;
  };
  T acc = zero_value<T>();
  if constexpr (M > 0) {
    constexpr int kTaps = 2 * M + 1;
    float wy[kTaps], wx[kTaps];
    const int row0 = axis_weights(pt.x, wy);
    const int col0 = axis_weights(pt.y, wx);
#pragma unroll
    for (int i = 0; i < kTaps; ++i) {
      T line = zero_value<T>();
#pragma unroll
      for (int j = 0; j < kTaps; ++j) line = scale_add(wx[j], tap(row0 + i, col0 + j), line);
      acc = scale_add(wy[i], line, acc);
    }
  } else {
    const int row0 = static_cast<int>(floorf(pt.x)) - m_run;
    const int col0 = static_cast<int>(floorf(pt.y)) - m_run;
    for (int i = 0; i <= 2 * m_run; ++i) {
      T line = zero_value<T>();
      for (int j = 0; j <= 2 * m_run; ++j) {
        const float wx = lanczos(pt.y - static_cast<float>(col0 + j));
        line = scale_add(wx, tap(row0 + i, col0 + j), line);
      }
      acc = scale_add(lanczos(pt.x - static_cast<float>(row0 + i)), line, acc);
    }
  }
  out[img * npoints + p] = acc;
}

// The same weights as the forward, with wy[i] v formed once a row; taps
// outside the grid are dropped.
template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
    lanczos_adj_kernel(const T* __restrict__ values,
                       const float2* __restrict__ points, T* __restrict__ grid,
                       long long npoints, int h, int w, int m_run,
                       int shared_points) {
  const long long p = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (p >= npoints) return;
  const long long img = blockIdx.y;
  const float2 pt = __ldg(points + (shared_points ? 0 : img * npoints) + p);
  const T v = __ldg(values + img * npoints + p);
  T* g = grid + img * h * w;
  if constexpr (M > 0) {
    constexpr int kTaps = 2 * M + 1;
    float wy[kTaps], wx[kTaps];
    const int row0 = axis_weights(pt.x, wy);
    const int col0 = axis_weights(pt.y, wx);
#pragma unroll
    for (int i = 0; i < kTaps; ++i) {
      const int row = row0 + i;
      if (row < 0 || row >= h) continue;
      const T rv = scale(wy[i], v);
      T* line = g + static_cast<long long>(row) * w;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const int col = col0 + j;
        if (col >= 0 && col < w) atomic_add(line + col, scale(wx[j], rv));
      }
    }
  } else {
    const int row0 = static_cast<int>(floorf(pt.x)) - m_run;
    const int col0 = static_cast<int>(floorf(pt.y)) - m_run;
    for (int i = 0; i <= 2 * m_run; ++i) {
      const int row = row0 + i;
      if (row < 0 || row >= h) continue;
      const T rv = scale(lanczos(pt.x - static_cast<float>(row)), v);
      T* line = g + static_cast<long long>(row) * w;
      for (int j = 0; j <= 2 * m_run; ++j) {
        const int col = col0 + j;
        if (col >= 0 && col < w) {
          atomic_add(line + col, scale(lanczos(pt.y - static_cast<float>(col)), rv));
        }
      }
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
  if (m == 1) {
    lanczos_fwd_kernel<1, T><<<grid, kThreads, 0, s>>>(image, points, out, npoints,
                                                       h, w, m, shared, cval);
  } else if (m == 2) {
    lanczos_fwd_kernel<2, T><<<grid, kThreads, 0, s>>>(image, points, out, npoints,
                                                       h, w, m, shared, cval);
  } else {
    lanczos_fwd_kernel<0, T><<<grid, kThreads, 0, s>>>(image, points, out, npoints,
                                                       h, w, m, shared, cval);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_adj(const T* values, const float2* points, T* grid_out,
                       int images, long long npoints, int h, int w, int m,
                       int shared, cudaStream_t s) {
  if (!valid(images, npoints, h, w, m)) return cudaErrorInvalidValue;
  if (npoints == 0) return cudaSuccess;
  const dim3 grid = grid_of(images, npoints);
  if (m == 1) {
    lanczos_adj_kernel<1, T><<<grid, kThreads, 0, s>>>(values, points, grid_out,
                                                       npoints, h, w, m, shared);
  } else if (m == 2) {
    lanczos_adj_kernel<2, T><<<grid, kThreads, 0, s>>>(values, points, grid_out,
                                                       npoints, h, w, m, shared);
  } else {
    lanczos_adj_kernel<0, T><<<grid, kThreads, 0, s>>>(values, points, grid_out,
                                                       npoints, h, w, m, shared);
  }
  return cudaGetLastError();
}

}  // namespace

// image (I, H, W), points (I, N, 2) or shared (N, 2), out (I, N); channels
// 2 for complex64, 1 for float32 (cval_im is then ignored).
extern "C" int tike_lanczos_first_form_fwd(const void* image, const void* points,
                                           void* out, int images, long long npoints,
                                           int h, int w, int m, int shared_points,
                                           int channels, float cval_re, float cval_im,
                                           void* stream) {
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

// values (I, N), points as above, grid (I, H, W), zeroed by the caller.
extern "C" int tike_lanczos_first_form_adj(const void* values, const void* points,
                                           void* grid, int images, long long npoints,
                                           int h, int w, int m, int shared_points,
                                           int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pts = static_cast<const float2*>(points);
  cudaError_t err;
  if (channels == 2) {
    err = launch_adj(static_cast<const float2*>(values), pts, static_cast<float2*>(grid),
                     images, npoints, h, w, m, shared_points, s);
  } else if (channels == 1) {
    err = launch_adj(static_cast<const float*>(values), pts, static_cast<float*>(grid),
                     images, npoints, h, w, m, shared_points, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

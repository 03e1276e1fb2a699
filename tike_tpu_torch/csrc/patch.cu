// Bilinear patch gather (patch_fwd) and its adjoint scatter-add (patch_adj)
// for NVIDIA Hopper, built for sm_90a with nvcc into a shared library with a
// plain C interface (loaded by tike_tpu_torch/kernels.py through ctypes).
//
// What they replace. The JAX package computes these two operators with the
// Pallas TPU kernels in tike_tpu/ops/patch_pallas.py:
//   - patch_fwd_pallas_elem (_patch_fwd_elem_kernel) and patch_fwd_pallas
//     (_patch_fwd_kernel) -> tike_patch_fwd below (one kernel for both);
//   - patch_adj_pallas (_patch_adj_kernel) -> tike_patch_adj below.
// The semantics are those of tike_tpu/ops/patch.py: positions are (y, x)
// min-corners; floor(pos) is the integer corner and pos - floor(pos) the
// bilinear weights; pixels outside [0, H) x [0, W) read as zero (forward)
// and are dropped (adjoint), which is the zero-padded edge of the JAX
// package, extended to negative corners, which read zero here.
//
// Layout. Images and patches are complex64 seen as interleaved float pairs
// (torch.view_as_real), or float32 for real inputs: T is float2 or float.
// Positions are (N, 2) float32, read as one float2 per patch.
//
// What bounds them on this card. Both are memory-bound: the forward reads
// the (P+1)^2 window of each patch (mostly from L2: a 1500^2 complex object
// is 18 MB, inside the 50 MB L2) and writes N P^2 complex values; the
// adjoint reads N P^2 values and performs 2 float atomicAdds per window
// pixel. At the slice's density about 7 patches of a 1000-position batch
// cover each object pixel, so atomics on overlapping windows contend in L2.
//
// The design is the simple one. The forward runs one thread per output
// pixel, reading its four neighbours straight from global memory (the four
// reads of a warp's 32 adjacent pixels overlap and coalesce). The adjoint
// runs one thread per window pixel: it forms the spread window value from
// the (up to) four patch pixels that touch it, then adds it into the image
// with one atomicAdd per float (no two threads of one patch hit the same
// address, so a warp's atomics do not serialize on each other). The
// summation order of overlapping patches varies from run to run.
// Left for later: staging each window in shared memory, binning positions
// by tile so the adjoint reduces in shared memory before one global add
// (which would also make it deterministic), and fusing the detector
// zero-pad and the probe product into the forward's store.
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

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

__device__ __forceinline__ float scale_add(float a, float x, float acc) {
  return fmaf(a, x, acc);
}

__device__ __forceinline__ float2 scale_add(float a, float2 x, float2 acc) {
  return make_float2(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y));
}

__device__ __forceinline__ void atomic_add_value(float* dst, float v) {
  atomicAdd(dst, v);
}

__device__ __forceinline__ void atomic_add_value(float2* dst, float2 v) {
  atomicAdd(&dst->x, v.x);
  atomicAdd(&dst->y, v.y);
}

template <typename T>
__device__ __forceinline__ T read_or_zero(const T* __restrict__ image, int r,
                                          int c, int h, int w) {
  if (r < 0 || r >= h || c < 0 || c >= w) return zero_value<T>();
  return image[static_cast<long long>(r) * w + c];
}

// patches[k, y, x] = sum of the four bilinear taps of image around
// (floor(pos[k]) + (y, x)), one thread per output pixel.
template <typename T>
__global__ void patch_fwd_kernel(const T* __restrict__ image,
                                 const float2* __restrict__ positions,
                                 T* __restrict__ patches, int n, int h, int w,
                                 int p) {
  const long long pp = static_cast<long long>(p) * p;
  const long long total = static_cast<long long>(n) * pp;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int k = static_cast<int>(i / pp);
    const int rem = static_cast<int>(i - k * pp);
    const int y = rem / p;
    const int x = rem - y * p;
    const float2 q = positions[k];
    const float ly = floorf(q.x);
    const float lx = floorf(q.y);
    const float fy = q.x - ly;
    const float fx = q.y - lx;
    const int r = static_cast<int>(ly) + y;
    const int c = static_cast<int>(lx) + x;
    T acc = zero_value<T>();
    acc = scale_add((1.0f - fy) * (1.0f - fx), read_or_zero(image, r, c, h, w),
                    acc);
    acc = scale_add((1.0f - fy) * fx, read_or_zero(image, r, c + 1, h, w), acc);
    acc = scale_add(fy * (1.0f - fx), read_or_zero(image, r + 1, c, h, w), acc);
    acc = scale_add(fy * fx, read_or_zero(image, r + 1, c + 1, h, w), acc);
    patches[i] = acc;
  }
}

// image[floor(pos[k]) + (yy, xx)] += spread window of patch k at (yy, xx),
// one thread per window pixel, (P+1)^2 per patch.
template <typename T>
__global__ void patch_adj_kernel(const T* __restrict__ patches,
                                 const float2* __restrict__ positions,
                                 T* __restrict__ image, int n, int h, int w,
                                 int p) {
  const int q1 = p + 1;
  const long long wsize = static_cast<long long>(q1) * q1;
  const long long total = static_cast<long long>(n) * wsize;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int k = static_cast<int>(i / wsize);
    const int rem = static_cast<int>(i - k * wsize);
    const int yy = rem / q1;
    const int xx = rem - yy * q1;
    const float2 q = positions[k];
    const float ly = floorf(q.x);
    const float lx = floorf(q.y);
    const int r = static_cast<int>(ly) + yy;
    const int c = static_cast<int>(lx) + xx;
    if (r < 0 || r >= h || c < 0 || c >= w) continue;
    const float fy = q.x - ly;
    const float fx = q.y - lx;
    const T* __restrict__ patch = patches + static_cast<long long>(k) * p * p;
    T acc = zero_value<T>();
    if (yy < p && xx < p)
      acc = scale_add((1.0f - fy) * (1.0f - fx), patch[yy * p + xx], acc);
    if (yy < p && xx > 0)
      acc = scale_add((1.0f - fy) * fx, patch[yy * p + xx - 1], acc);
    if (yy > 0 && xx < p)
      acc = scale_add(fy * (1.0f - fx), patch[(yy - 1) * p + xx], acc);
    if (yy > 0 && xx > 0)
      acc = scale_add(fy * fx, patch[(yy - 1) * p + xx - 1], acc);
    atomic_add_value(image + static_cast<long long>(r) * w + c, acc);
  }
}

int blocks_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int tike_patch_fwd(const void* image, const void* positions,
                              void* patches, int n, int h, int w, int p,
                              int channels, void* stream) {
  const long long total = static_cast<long long>(n) * p * p;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(total);
  const float2* pos = static_cast<const float2*>(positions);
  if (channels == 2) {
    patch_fwd_kernel<float2><<<blocks, kThreads, 0, s>>>(
        static_cast<const float2*>(image), pos, static_cast<float2*>(patches),
        n, h, w, p);
  } else if (channels == 1) {
    patch_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(image), pos, static_cast<float*>(patches), n,
        h, w, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tike_patch_adj(const void* patches, const void* positions,
                              void* image, int n, int h, int w, int p,
                              int channels, void* stream) {
  const long long total = static_cast<long long>(n) * (p + 1) * (p + 1);
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(total);
  const float2* pos = static_cast<const float2*>(positions);
  if (channels == 2) {
    patch_adj_kernel<float2><<<blocks, kThreads, 0, s>>>(
        static_cast<const float2*>(patches), pos, static_cast<float2*>(image),
        n, h, w, p);
  } else if (channels == 1) {
    patch_adj_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(patches), pos, static_cast<float*>(image), n,
        h, w, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

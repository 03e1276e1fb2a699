// Kaiser-Bessel interpolation between a uniform n^3 grid and non-uniform
// points (kb_gather) and its adjoint, spreading onto the grid (kb_scatter),
// for NVIDIA Hopper, built for sm_90a with nvcc into a shared library with a
// plain C interface (loaded by tike_tpu_torch/kernels.py through ctypes).
//
// What they replace. The JAX package has no Pallas kernel for these: it
// writes the interpolation as XLA code shaped for the TPU. gather_kb and
// scatter_kb (tike_tpu/ops/usfft.py:214-271) scan the (2m)^3 taps, one
// batched gather or scatter-add of all N points per tap; gather_kb_rows and
// scatter_kb_rows (:330-397), which laminography runs, spread each axis's
// 2m taps into dense length-n rows and contract them with einsums on the
// matrix unit. These kernels take the original tike's GPU design instead
// (usfft.cu:103-140 there): one thread per point.
//
// Semantics (tike_tpu/ops/usfft.py). The grid is the centred, fftshifted
// transform, n^3 complex64 seen as float2. Point i has frequencies x[i] (3
// float32, any real value: laminography's plane corners lie outside
// [-0.5, 0.5) and wrap). On each axis, v = n x (rounded once, as the plain
// version rounds it), ell = floor(v), and the 2m taps are ell + 1 - m ... ell
// + m at grid index (n/2 + tap) mod n, with the weight
//     phi(d) = I0(beta sqrt(1 - (d/m)^2)) / I0(beta),   d = v - tap.
// A 3-D tap's weight is (w0 w1) w2, in that order, as in the JAX package.
// I0 is CUDA's cyl_bessel_i0f (at most 6 ulp); the plain version uses
// torch.special.i0e and exp, equal to a few ulp.
//
// kb_gather_kernel: out[i] = sum over the (2m)^3 taps of weight * grid[tap],
// in the tap order of the plain version (axis 0 outermost). Deterministic.
// kb_scatter_kernel: grid[tap] += weight * values[i] for every tap, with
// Hopper's float2 atomicAdd into a grid the launcher zeroes first. The order
// of the additions into one grid value varies from run to run, so the result
// is not bitwise repeatable (deterministic: false).
//
// What bounds them on this card: bytes. A gather must read the grid values
// its points touch (at laminography's 128^3 grid and 64 angles, nearly all
// of the 16.8 MB), the 12 bytes of each point's x, and write 8 bytes per
// point; a scatter reads the values and x and writes the whole grid once:
// both about 37.7 MB there, 11 us at 3.35 TB/s. The arithmetic, about
// 4 (2m)^3 flops per point plus 6m Bessel functions, is under a tenth of
// that at m = 1. The design is the simple one: each thread computes its
// 3 x 2m weights and wrapped indices in registers (m is a template
// parameter; the loops over axes 1 and 2 unroll, the one over axis 0 does
// not, which keeps the build short at m = 6), then reads or adds its taps; the grid's
// reads go through the read-only path. Neighbouring points of a row of
// laminography's grids touch neighbouring grid values, so the taps of a
// warp share L2 lines; the whole 16.8 MB grid fits the 50 MB L2. Sharing the
// axis-0 weights along a row and a tile-owned deterministic scatter are
// later work.
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 6;

// The 2m weights and wrapped grid indices of one axis of one point.
template <int M>
__device__ __forceinline__ void axis_taps(float xa, int n, float beta,
                                          float i0_beta, float* w, int* g) {
  // __fmul_rn and friends keep nvcc from contracting into FMAs, so v, d and
  // the floor are those of the plain version, which rounds each step.
  const float v = __fmul_rn(static_cast<float>(n), xa);
  const float ellf = floorf(v);
  const int ell = static_cast<int>(ellf);
  const int half = n / 2;
#pragma unroll
  for (int j = 0; j < 2 * M; ++j) {
    const float d = __fsub_rn(v, ellf + static_cast<float>(j + 1 - M));
    const float t = __fdiv_rn(d, static_cast<float>(M));
    const float s = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(t, t)), 0.0f));
    w[j] = __fdiv_rn(cyl_bessel_i0f(__fmul_rn(beta, s)), i0_beta);
    int gi = (half + ell + j + 1 - M) % n;
    g[j] = gi < 0 ? gi + n : gi;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    kb_gather_kernel(const float2* __restrict__ grid,
                     const float* __restrict__ x, float2* __restrict__ out,
                     long long npoints, int n, float beta, float i0_beta) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npoints) return;
  float w0[2 * M], w1[2 * M], w2[2 * M];
  int g0[2 * M], g1[2 * M], g2[2 * M];
  axis_taps<M>(__ldg(x + 3 * i), n, beta, i0_beta, w0, g0);
  axis_taps<M>(__ldg(x + 3 * i + 1), n, beta, i0_beta, w1, g1);
  axis_taps<M>(__ldg(x + 3 * i + 2), n, beta, i0_beta, w2, g2);
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 1
  for (int j0 = 0; j0 < 2 * M; ++j0) {
#pragma unroll
    for (int j1 = 0; j1 < 2 * M; ++j1) {
      const float w01 = __fmul_rn(w0[j0], w1[j1]);
      const long long row =
          (static_cast<long long>(g0[j0]) * n + g1[j1]) * n;
#pragma unroll
      for (int j2 = 0; j2 < 2 * M; ++j2) {
        const float w = __fmul_rn(w01, w2[j2]);
        const float2 v = __ldg(grid + row + g2[j2]);
        acc.x = fmaf(v.x, w, acc.x);
        acc.y = fmaf(v.y, w, acc.y);
      }
    }
  }
  out[i] = acc;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    kb_scatter_kernel(const float2* __restrict__ values,
                      const float* __restrict__ x, float2* __restrict__ grid,
                      long long npoints, int n, float beta, float i0_beta) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npoints) return;
  float w0[2 * M], w1[2 * M], w2[2 * M];
  int g0[2 * M], g1[2 * M], g2[2 * M];
  axis_taps<M>(__ldg(x + 3 * i), n, beta, i0_beta, w0, g0);
  axis_taps<M>(__ldg(x + 3 * i + 1), n, beta, i0_beta, w1, g1);
  axis_taps<M>(__ldg(x + 3 * i + 2), n, beta, i0_beta, w2, g2);
  const float2 f = values[i];
#pragma unroll 1
  for (int j0 = 0; j0 < 2 * M; ++j0) {
#pragma unroll
    for (int j1 = 0; j1 < 2 * M; ++j1) {
      const float w01 = __fmul_rn(w0[j0], w1[j1]);
      const long long row =
          (static_cast<long long>(g0[j0]) * n + g1[j1]) * n;
#pragma unroll
      for (int j2 = 0; j2 < 2 * M; ++j2) {
        const float w = __fmul_rn(w01, w2[j2]);
        atomicAdd(grid + row + g2[j2],
                  make_float2(__fmul_rn(f.x, w), __fmul_rn(f.y, w)));
      }
    }
  }
}

template <int M>
cudaError_t launch(bool gather, const void* in, const float* x, void* out,
                   long long npoints, int n, float beta, float i0_beta,
                   cudaStream_t stream) {
  const long long blocks = (npoints + kThreads - 1) / kThreads;
  if (gather) {
    kb_gather_kernel<M><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const float2*>(in), x,
                                    static_cast<float2*>(out), npoints, n,
                                    beta, i0_beta);
  } else {
    kb_scatter_kernel<M><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(static_cast<const float2*>(in), x,
                                     static_cast<float2*>(out), npoints, n,
                                     beta, i0_beta);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(bool gather, const void* in, const float* x, void* out,
                     long long npoints, int n, int m, float beta,
                     float i0_beta, cudaStream_t stream) {
  if (npoints <= 0) return cudaGetLastError();
  switch (m) {
    case 1: return launch<1>(gather, in, x, out, npoints, n, beta, i0_beta, stream);
    case 2: return launch<2>(gather, in, x, out, npoints, n, beta, i0_beta, stream);
    case 3: return launch<3>(gather, in, x, out, npoints, n, beta, i0_beta, stream);
    case 4: return launch<4>(gather, in, x, out, npoints, n, beta, i0_beta, stream);
    case 5: return launch<5>(gather, in, x, out, npoints, n, beta, i0_beta, stream);
    case kMaxM: return launch<kMaxM>(gather, in, x, out, npoints, n, beta, i0_beta, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (npoints) complex64 = the grid (n^3 complex64, centred) interpolated
// at x (npoints, 3) float32 with the 2m-tap window of parameter beta;
// i0_beta is I0(beta).
extern "C" int tike_kb_gather(const void* grid, const void* x, void* out,
                              long long npoints, int n, int m, float beta,
                              float i0_beta, void* stream) {
  return static_cast<int>(dispatch(true, grid, static_cast<const float*>(x),
                                   out, npoints, n, m, beta, i0_beta,
                                   static_cast<cudaStream_t>(stream)));
}

// grid (n^3 complex64) = zero, then the values (npoints complex64) spread at
// x (npoints, 3) float32; the adjoint of tike_kb_gather.
extern "C" int tike_kb_scatter(const void* values, const void* x, void* grid,
                               long long npoints, int n, int m, float beta,
                               float i0_beta, void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(n) * n * n * sizeof(float2);
  cudaError_t rc = cudaMemsetAsync(grid, 0, bytes, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(dispatch(false, values, static_cast<const float*>(x),
                                   grid, npoints, n, m, beta, i0_beta, s));
}

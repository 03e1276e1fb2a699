// The first form of the Bucket laminography kernels (csrc/bucket.cu before
// its redesign), kept unchanged as a yardstick: chip_smoke.py builds it
// beside the other sources and times it against csrc/bucket.cu's kernels in
// the same call. No path of the package runs it.
//
// bucket_fwd_kernel: one thread per (voxel, angle), a float2 atomicAdd
// into the plane per point (not bitwise repeatable). bucket_adj_kernel: one
// thread per voxel, angles outer and offsets inner, __ldg gathers, bitwise
// equal to the plain version. Both compute each point's cell in the JAX
// package's order of float32 operations, each rounded on its own
// (__fmul_rn / __fadd_rn), from a (T, 8) table of each angle's
// trigonometry (the first 8 columns of tike_tpu_torch/ops/bucket.py::
// bucket_trig's table), and recompute per
// point the sub-voxel offset as a float64 division and the wrap as two
// integer floor-mods.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableWidth = 8;  // the row stride of the table it reads
constexpr int kMaxAnglesPerLaunch = 65535;

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// The voxel's coordinates: from the grid, or from its index in the full
// lattice (make_grid(n): axis 0 slowest, each axis from -ceil(n/2)).
__device__ __forceinline__ void voxel(const int* __restrict__ grid, long long g, int n,
                                      float& g0, float& g1, float& g2) {
  if (grid != nullptr) {
    g0 = static_cast<float>(__ldg(grid + 3 * g + 0));
    g1 = static_cast<float>(__ldg(grid + 3 * g + 1));
    g2 = static_cast<float>(__ldg(grid + 3 * g + 2));
  } else {
    const long long nn = static_cast<long long>(n) * n;
    const int lo = (n + 1) / 2;
    g0 = static_cast<float>(static_cast<int>(g / nn) - lo);
    g1 = static_cast<float>(static_cast<int>((g / n) % n) - lo);
    g2 = static_cast<float>(static_cast<int>(g % n) - lo);
  }
}

struct Angle {
  float nx, ny, nz, st, cqct, sqct, nsq, cq;
};

__device__ __forceinline__ Angle angle_row(const float* __restrict__ table, int t) {
  const float* r = table + kTableWidth * t;
  return Angle{__ldg(r + 0), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3),
               __ldg(r + 4), __ldg(r + 5), __ldg(r + 6), __ldg(r + 7)};
}

// The sub-voxel offset (i + 0.5) / precision, as the float64 quotient
// rounded to float32 (numpy's _subsample_offsets).
__device__ __forceinline__ float offset(int i, int precision) {
  return static_cast<float>(__ddiv_rn(static_cast<double>(i) + 0.5,
                                      static_cast<double>(precision)));
}

// The plane cell of point p for one angle, in the JAX package's order of
// float32 operations, each rounded on its own.
__device__ __forceinline__ long long cell(const Angle& a, float p0, float p1, float p2,
                                          int n) {
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(p0, a.nx), __fmul_rn(p1, a.ny)),
                            __fmul_rn(p2, a.nz));
  const float px = __fsub_rn(p0, __fmul_rn(d, a.nx));
  const float py = __fsub_rn(p1, __fmul_rn(d, a.ny));
  const float pz = __fsub_rn(p2, __fmul_rn(d, a.nz));
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(a.st, px), __fmul_rn(a.cqct, py)),
                            __fmul_rn(a.sqct, pz));
  const float z = __fadd_rn(__fmul_rn(a.nsq, py), __fmul_rn(a.cq, pz));
  const int half = n / 2;
  const int iy = floor_mod(static_cast<int>(floorf(y)) + half, n);
  const int iz = floor_mod(static_cast<int>(floorf(z)) + half, n);
  return static_cast<long long>(iy) * n + iz;
}

__global__ void __launch_bounds__(kThreads)
bucket_fwd_kernel(const float2* __restrict__ u, const int* __restrict__ grid,
                  const float* __restrict__ table, float2* __restrict__ planes,
                  long long voxels, int n, int precision, float weight) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= voxels) return;
  const int t = blockIdx.y;
  const Angle a = angle_row(table, t);
  float g0, g1, g2;
  voxel(grid, g, n, g0, g1, g2);
  const float2 value = __ldg(u + g);
  const float2 w = make_float2(__fmul_rn(value.x, weight), __fmul_rn(value.y, weight));
  float2* plane = planes + static_cast<long long>(t) * n * n;
  for (int i = 0; i < precision; ++i) {
    const float p0 = __fadd_rn(g0, offset(i, precision));
    for (int j = 0; j < precision; ++j) {
      const float p1 = __fadd_rn(g1, offset(j, precision));
      for (int k = 0; k < precision; ++k) {
        const float p2 = __fadd_rn(g2, offset(k, precision));
        atomicAdd(plane + cell(a, p0, p1, p2, n), w);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_adj_kernel(const float2* __restrict__ planes, const int* __restrict__ grid,
                  const float* __restrict__ table, float2* __restrict__ out,
                  long long voxels, int angles, int n, int precision, float weight) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= voxels) return;
  float g0, g1, g2;
  voxel(grid, g, n, g0, g1, g2);
  float2 acc = make_float2(0.0f, 0.0f);
  for (int t = 0; t < angles; ++t) {
    const Angle a = angle_row(table, t);
    const float2* plane = planes + static_cast<long long>(t) * n * n;
    for (int i = 0; i < precision; ++i) {
      const float p0 = __fadd_rn(g0, offset(i, precision));
      for (int j = 0; j < precision; ++j) {
        const float p1 = __fadd_rn(g1, offset(j, precision));
        for (int k = 0; k < precision; ++k) {
          const float p2 = __fadd_rn(g2, offset(k, precision));
          const float2 v = __ldg(plane + cell(a, p0, p1, p2, n));
          acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, weight));
          acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, weight));
        }
      }
    }
  }
  out[g] = acc;
}

bool valid(long long voxels, int angles, int n, int precision) {
  return voxels >= 0 && angles >= 0 && n >= 1 && n <= 46340 && precision >= 1;
}

unsigned int voxel_blocks(long long voxels) {
  return static_cast<unsigned int>((voxels + kThreads - 1) / kThreads);
}

}  // namespace

// planes (angles x n x n complex64), every value written = the forward
// projection of u (voxels complex64) at the voxels of grid (voxels x 3 int32,
// or NULL for the full n^3 lattice in make_grid's order) for the angles of
// table (angles x 8 float32, see above), each point weighted by weight
// (1 / precision^3 as float32). Returns a cudaError_t.
extern "C" int tike_bucket_first_form_fwd(const void* u, const void* grid, const void* table,
                               void* planes, long long voxels, int angles, int n,
                               int precision, float weight, void* stream) {
  if (!valid(voxels, angles, n, precision)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(n) * n;
  if (angles == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(planes, 0, sizeof(float2) * plane * angles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (voxels == 0) return static_cast<int>(cudaGetLastError());
  const float2* uu = static_cast<const float2*>(u);
  const int* gg = static_cast<const int*>(grid);
  const float* tt = static_cast<const float*>(table);
  float2* pp = static_cast<float2*>(planes);
  for (int t0 = 0; t0 < angles; t0 += kMaxAnglesPerLaunch) {
    const int count = angles - t0 < kMaxAnglesPerLaunch ? angles - t0 : kMaxAnglesPerLaunch;
    const dim3 blocks(voxel_blocks(voxels), static_cast<unsigned int>(count));
    bucket_fwd_kernel<<<blocks, kThreads, 0, s>>>(uu, gg, tt + kTableWidth * t0,
                                                  pp + plane * t0, voxels, n, precision,
                                                  weight);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// out (voxels complex64), every value written = the adjoint of
// tike_bucket_first_form_fwd applied to planes (angles x n x n complex64).
extern "C" int tike_bucket_first_form_adj(const void* planes, const void* grid, const void* table,
                               void* out, long long voxels, int angles, int n,
                               int precision, float weight, void* stream) {
  if (!valid(voxels, angles, n, precision)) return static_cast<int>(cudaErrorInvalidValue);
  if (voxels == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bucket_adj_kernel<<<voxel_blocks(voxels), kThreads, 0, s>>>(
      static_cast<const float2*>(planes), static_cast<const int*>(grid),
      static_cast<const float*>(table), static_cast<float2*>(out), voxels, angles, n,
      precision, weight);
  return static_cast<int>(cudaGetLastError());
}

// The far-field step of the Gaussian noise model (farplane_gaussian_kernel)
// for NVIDIA Hopper, built for sm_90a with nvcc into a shared library with a
// plain C interface (loaded by tike_tpu_torch/kernels.py through ctypes).
//
// What it replaces. No Pallas kernel: the JAX package leaves this step to
// XLA, which fuses it (tike_tpu/ptycho/solvers/lstsq.py:140-172, rpie.py
// :113-155). The port ran it as about twenty ATen kernels a batch: the
// intensity (abs, square, a sum over the modes), the per-pattern cost over
// the measured pixels, the amplitude gradient's scale, its product with the
// farplane, and the select of the measured pixels. It computes what
// tike_tpu_torch/ops/objective.py::gaussian_farplane_plain computes:
//   I = sum over the K modes of re^2 + im^2;
//   cost[b] = sum over measured pixels of (sqrt(I) - sqrt(d))^2 / measured;
//   chi = -farplane * (1 - sqrt(d) / (sqrt(I) + 1e-9)) on measured pixels,
//         farplane * (s - 1) elsewhere;
// in float32, with IEEE sqrt and division (no fast math).
//
// Layout. farplane and chi are (B, K, D, D) complex64 seen as interleaved
// float pairs, K the product of the mode axes; data (B, D, D) float32; the
// mask (D, D) bool, one byte a pixel; costs (B,) float32. chi may be the
// farplane itself: each thread reads all the modes of its pixels before it
// writes any of them, and no other thread touches those pixels.
//
// What bounds it on this card: bytes. It must read the farplane, the data
// and the mask and write chi and the costs once: at 1,000 x 128^2 that is
// 0.33 GB with one mode (98 us at 3.35 TB/s) and 0.85 GB with three
// (254 us); the arithmetic (about 10 flops and two square roots a pixel and
// mode) is far below. The ATen chain moved about ten times those bytes.
//
// Design. A block makes one pattern, so the pattern's cost needs no second
// pass and no atomics: each thread walks the pattern's pixels two at a time
// (one 16-byte load or store is two complex values; one at a time, 8 bytes,
// where D^2 is odd or a pointer is not aligned for that), with a stride of
// the block, so a warp's loads are contiguous. It loads kUnroll groups of
// pixels (every mode's values, the data, the mask) before it computes, so
// that several loads are in flight, keeps the modes in registers for K <= 4
// (above, it reads them again for the write, from L1 or L2), and writes chi
// with the same stride. Each thread adds its measured pixels' terms in the
// order it meets them; the block then sums the threads' terms by warp
// shuffles in a fixed tree and the warps' sums in warp order, so the costs
// are the same bit for bit from run to run. The block counts the measured
// pixels of the mask itself, so nothing is read back to the host. The
// farplane and the data are read and chi written with the streaming
// (evict-first) hints: each byte is touched once. 128 threads and at most
// 64 registers a thread let 8 blocks share an SM, so a batch of 1,000
// patterns fills the card's 132 SMs in one wave.
//
// The launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Blocks per SM the compiler sizes registers for (64 registers a thread).
constexpr int kMinBlocks = 8;
// Groups of pixels a thread loads before it computes.
constexpr int kUnroll = 2;
// Streaming (evict-first) loads of the farplane and data and stores of chi.
constexpr bool kStreaming = true;

// V complex values (2V floats) at p, V = 2 (one float4) or 1 (one float2).
template <int V>
__device__ __forceinline__ void load_field(const float* p, float* v) {
  if constexpr (V == 2) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 x = kStreaming ? __ldcs(q) : *q;
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 x = kStreaming ? __ldcs(q) : *q;
    v[0] = x.x;
    v[1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void store_field(float* p, const float* v) {
  if constexpr (V == 2) {
    const float4 x = make_float4(v[0], v[1], v[2], v[3]);
    if (kStreaming) {
      __stcs(reinterpret_cast<float4*>(p), x);
    } else {
      *reinterpret_cast<float4*>(p) = x;
    }
  } else {
    const float2 x = make_float2(v[0], v[1]);
    if (kStreaming) {
      __stcs(reinterpret_cast<float2*>(p), x);
    } else {
      *reinterpret_cast<float2*>(p) = x;
    }
  }
}

// V data values and mask bytes at pixel index i of a pattern.
template <int V>
__device__ __forceinline__ void load_data(const float* data, const unsigned char* mask,
                                          int i, float* d, bool* m) {
  if constexpr (V == 2) {
    const float2* q = reinterpret_cast<const float2*>(data + i);
    const float2 x = kStreaming ? __ldcs(q) : *q;
    const uchar2 y = __ldg(reinterpret_cast<const uchar2*>(mask + i));
    d[0] = x.x;
    d[1] = x.y;
    m[0] = y.x != 0;
    m[1] = y.y != 0;
  } else {
    d[0] = kStreaming ? __ldcs(data + i) : data[i];
    m[0] = __ldg(mask + i) != 0;
  }
}

// kModes > 0 (1 to 4): the number of modes, held in registers; 0: ``modes``
// at run time, each read twice.
template <int V, int kModes>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    farplane_gaussian_kernel(const float* farplane, const float* __restrict__ data,
                             const unsigned char* __restrict__ mask, float* chi,
                             float* __restrict__ costs, int modes, int pixels,
                             float unmeasured) {
  const int nmodes = kModes > 0 ? kModes : modes;
  constexpr int kHeld = kModes > 0 ? kModes : 1;
  const long long plane = 2LL * pixels;  // floats of one mode's plane
  const long long base = static_cast<long long>(blockIdx.x) * nmodes * plane;
  const float* field = farplane + base;
  float* out = chi + base;
  const float* d_pattern = data + static_cast<long long>(blockIdx.x) * pixels;
  const int groups = pixels / V;

  float cost = 0.0f;
  int measured = 0;
  for (int g0 = threadIdx.x; g0 < groups; g0 += kUnroll * kThreads) {
    float v[kUnroll][kHeld][2 * V];
    float d[kUnroll][V];
    bool m[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (g < groups) {
        load_data<V>(d_pattern, mask, g * V, d[u], m[u]);
        if constexpr (kModes > 0) {
#pragma unroll
          for (int k = 0; k < kModes; ++k) {
            load_field<V>(field + k * plane + 2LL * V * g, v[u][k]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (g >= groups) {
        continue;
      }
      float intensity[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        intensity[j] = 0.0f;
      }
      if constexpr (kModes > 0) {
#pragma unroll
        for (int k = 0; k < kModes; ++k) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float re = v[u][k][2 * j], im = v[u][k][2 * j + 1];
            intensity[j] += re * re + im * im;
          }
        }
      } else {
        for (int k = 0; k < nmodes; ++k) {
          float w[2 * V];
          load_field<V>(field + k * plane + 2LL * V * g, w);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            intensity[j] += w[2 * j] * w[2 * j] + w[2 * j + 1] * w[2 * j + 1];
          }
        }
      }
      // chi = farplane * factor: -(1 - sqrt(d) / (sqrt(I) + 1e-9)) where
      // measured, s - 1 elsewhere.
      float factor[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (m[u][j]) {
          const float amplitude = sqrtf(intensity[j]);
          const float measured_amplitude = sqrtf(d[u][j]);
          const float diff = amplitude - measured_amplitude;
          cost += diff * diff;
          measured += 1;
          factor[j] = -(1.0f - measured_amplitude / (amplitude + 1e-9f));
        } else {
          factor[j] = unmeasured;
        }
      }
#pragma unroll
      for (int k = 0; k < nmodes; ++k) {
        float w[2 * V];
        if constexpr (kModes > 0) {
#pragma unroll
          for (int q = 0; q < 2 * V; ++q) {
            w[q] = v[u][k][q];
          }
        } else {
          load_field<V>(field + k * plane + 2LL * V * g, w);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          w[2 * j] *= factor[j];
          w[2 * j + 1] *= factor[j];
        }
        store_field<V>(out + k * plane + 2LL * V * g, w);
      }
    }
  }

  // The pattern's sums: a fixed tree over each warp's lanes, then the warps
  // in order.
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    cost += __shfl_down_sync(0xffffffffu, cost, offset);
    measured += __shfl_down_sync(0xffffffffu, measured, offset);
  }
  __shared__ float warp_cost[kWarps];
  __shared__ int warp_measured[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    warp_cost[warp] = cost;
    warp_measured[warp] = measured;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    int count = 0;
    for (int w = 0; w < kWarps; ++w) {
      total += warp_cost[w];
      count += warp_measured[w];
    }
    costs[blockIdx.x] = total / static_cast<float>(count);
  }
}

template <int V, int kModes>
void launch(const float* farplane, const float* data, const unsigned char* mask, float* chi,
            float* costs, int patterns, int modes, int pixels, float unmeasured,
            cudaStream_t stream) {
  farplane_gaussian_kernel<V, kModes><<<patterns, kThreads, 0, stream>>>(
      farplane, data, mask, chi, costs, modes, pixels, unmeasured);
}

template <int V>
void launch_modes(const float* farplane, const float* data, const unsigned char* mask,
                  float* chi, float* costs, int patterns, int modes, int pixels,
                  float unmeasured, cudaStream_t stream) {
  switch (modes) {
    case 1:
      launch<V, 1>(farplane, data, mask, chi, costs, patterns, modes, pixels, unmeasured, stream);
      break;
    case 2:
      launch<V, 2>(farplane, data, mask, chi, costs, patterns, modes, pixels, unmeasured, stream);
      break;
    case 3:
      launch<V, 3>(farplane, data, mask, chi, costs, patterns, modes, pixels, unmeasured, stream);
      break;
    case 4:
      launch<V, 4>(farplane, data, mask, chi, costs, patterns, modes, pixels, unmeasured, stream);
      break;
    default:
      launch<V, 0>(farplane, data, mask, chi, costs, patterns, modes, pixels, unmeasured, stream);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// farplane, chi (B, K, D, D) complex64 (chi may be farplane); data (B, D, D)
// float32; mask (D, D) bool; costs (B,) float32; pixels = D * D;
// unmeasured = s - 1.
extern "C" int tike_farplane_gaussian(const void* farplane, const void* data, const void* mask,
                                      void* chi, void* costs, int patterns, int modes,
                                      int pixels, float unmeasured, void* stream) {
  if (patterns <= 0 || modes <= 0 || pixels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f = static_cast<const float*>(farplane);
  const auto* d = static_cast<const float*>(data);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* c = static_cast<float*>(chi);
  auto* out = static_cast<float*>(costs);
  auto s = static_cast<cudaStream_t>(stream);
  const bool pairs = pixels % 2 == 0 && aligned(f, 16) && aligned(c, 16) && aligned(d, 8) &&
                     aligned(m, 2);
  if (pairs) {
    launch_modes<2>(f, d, m, c, out, patterns, modes, pixels, unmeasured, s);
  } else {
    launch_modes<1>(f, d, m, c, out, patterns, modes, pixels, unmeasured, s);
  }
  return static_cast<int>(cudaGetLastError());
}

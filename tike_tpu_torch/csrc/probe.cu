// Seven small kernels, one for each feature probe of the JAX package's
// scripts/pallas_probe.py, for NVIDIA Hopper (sm_90a), built with nvcc into
// a shared library with a plain C interface (loaded by
// tike_tpu_torch/kernels.py through ctypes; driven by
// tike_tpu_torch/toolchain_probe.py).
//
// The Pallas probes asked which Mosaic features the TPU's compiler accepts;
// each of these computes what its probe computes, with the card's own form
// of the feature, so that a run shows the toolchain builds and launches it:
//   - probe_trivial_kernel    (trivial, :41-48): o = 2 x, one block (the
//     Pallas probe has no grid, so one block is the feature). 16,384 floats
//     are 131,072 bytes to move, nothing to the card but all of it through
//     one SM: its 1,024 threads each keep four 16-byte loads in flight and
//     store 16 bytes at a time (0.0025-0.0027 ms in a CUDA graph; 256
//     threads with 4-byte loads took 0.0029-0.0030; torch.mul, on many
//     SMs, 0.0014-0.0017; NVIDIA H100 80GB HBM3, 700 W);
//   - probe_gridded_kernel    (gridded, :52-63): o = 2 x over (8, 128, 128),
//     a 2-D launch grid (plane, row), a thread per column;
//   - probe_prefetch_kernel   (prefetch, :67-89): o[i] = x[idx[i]] + 1, each
//     block reading its plane's index from the index array (Pallas fetched
//     it ahead of the grid as a scalar prefetch);
//   - probe_static_dma_kernel (static_dma, :93-113): the window x[0:128,
//     0:128], at offsets fixed when compiled, copied into shared memory by
//     16-byte cp.async (Ampere's asynchronous copy), then out. 128 KB to
//     move is a launch and one load latency: 32 blocks of 4 rows, each of
//     128 threads copying one 16-byte chunk, waiting on its own copy group
//     alone (no block barrier) and storing the chunk it copied as a float4;
//   - probe_dynamic_dma_kernel (dynamic_dma, :117-151): o[i] =
//     big[cy:cy+128, cx:cx+256] with (cy, cx) read from an index array,
//     each row brought into shared memory by Hopper's bulk asynchronous copy
//     (cp.async.bulk, the TMA engine without a tensor map) completing on an
//     mbarrier, one row per lane of one warp, and each band of 8 rows sent
//     back out by one bulk copy from shared to global memory (a
//     bulk_group). The block is that one warp: no thread touches the data. A bulk copy needs
//     16-byte aligned addresses and sizes; these windows ([8i, 16i]) start on
//     64-byte boundaries, and the wrapper refuses others;
//   - probe_element_kernel<false> (element_static, :155-173): o[i] =
//     2 big[8i:+128, 16i:+256], the starts computed from the block index;
//   - probe_element_kernel<true> (element_prefetch, :178-204): o[i] =
//     2 big[9i+3:+128, 17i+5:+256], the starts read from an index array.
//     Pallas's pl.Element blocks start at any element; a 16-byte load
//     cannot. Each thread loads the float4 of its output from the row's
//     span widened down to 16 bytes (at most 3 floats more on each side,
//     inside the row, as the row width is a multiple of 4) and takes the
//     next float4 from its neighbouring lane by a shuffle, so a window
//     that starts `lead` floats past a 16-byte boundary costs one load
//     latency and one float4 store per output float4; [8i, 16i] has lead 0
//     (16i floats is a multiple of 64 bytes), [9i+3, 17i+5] does not.
// The windows' wrappers take a multiple of kBandRows rows, and each window
// kernel's band divides it.
//
// Measured (python -m tike_tpu_torch.kernel_sweep --source probe: ms per
// launch, 100 launches in a CUDA graph, median of three rounds; NVIDIA H100
// 80GB HBM3, 700.00 W). element_static / element_prefetch, library call
// (torch.mul of a strided view) 0.00207 / 0.00207:
//   (b) no shared memory, float4, 4-row bands (kept) 0.00156 / 0.00185;
//       8 rows 0.00162 / 0.00187; 16 rows 0.00174 / 0.00199; 32 rows
//       0.00202 / 0.00250; 4-byte loads and stores at 4, 8, 16, 32 rows
//       0.00162 / 0.00180, 0.00179 / 0.00188, 0.00196 / 0.00210, 0.00233 /
//       0.00244;
//   (a) staged by bulk copies, float4 stores, at 4, 8, 16, 32 rows 0.00194 /
//       0.00221, 0.00204 / 0.00225, 0.00225 / 0.00261, 0.00298 / 0.00335;
//       4-byte stores 0.00196 / 0.00215, 0.00204 / 0.00222, 0.00225 /
//       0.00240, 0.00295 / 0.00312.
// static_dma, clone of the view 0.00132: 4-row bands of 128 threads (kept)
// 0.00126-0.00128, of 64 threads 0.00129; 8 rows 0.00130 (64 threads
// 0.00133); 16 rows 0.00135 (0.00142); 32 rows 0.00152 (0.00162).
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTrivialThreads = 1024;  // one block, the most it can hold
constexpr int kDmaThreads = 32;        // one warp: a lane per row of a band
constexpr int kDmaRows = 8;            // rows of a dynamic_dma band
constexpr int kBandRows = 8;           // the wrappers' row tile
constexpr int kStaticRows = 128, kStaticCols = 128;  // x[0:128, 0:128]
constexpr int kStaticRow0 = 0, kStaticCol0 = 0;
constexpr int kStaticBandRows = 4;     // rows of a static_dma block
constexpr int kStaticThreads = 128;
constexpr int kWindowCols = 256;                     // big[.., +256]
constexpr int kElementStepY = 8, kElementStepX = 16;  // element_static
constexpr int kElementRows = 4;        // rows of an element block
// The element kernel's two forms, kept for the sweep (kernel_sweep.py):
// (a) staged: the rows' widened spans brought into shared memory by bulk
// copies on an mbarrier, then read back shifted; (b) the one kept: no
// shared memory. Either stores float4s, or 4-byte values with
// kElementVectors false.
constexpr bool kElementStaged = false;
constexpr bool kElementVectors = true;
constexpr int kElementPitch = kWindowCols + 4;  // staged rows: room for the lead

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_expect_tx(unsigned bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// both 16-byte aligned, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from shared to global memory,
// both 16-byte aligned, in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

// Close the thread's bulk group and wait until its copies have read their
// shared memory (the block may then exit; the writes land by kernel end).
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
}

// The four floats that start `lead` (0-3, the same in every lane of a
// warp) floats into the eight of a and b.
__device__ __forceinline__ float4 shifted(float4 a, float4 b, int lead) {
  switch (lead) {
    case 0: return a;
    case 1: return make_float4(a.y, a.z, a.w, b.x);
    case 2: return make_float4(a.z, a.w, b.x, b.y);
    default: return make_float4(a.w, b.x, b.y, b.z);
  }
}

__device__ __forceinline__ float4 shfl_down(float4 v, int delta) {
  constexpr unsigned kAll = 0xffffffffu;
  return make_float4(
      __shfl_down_sync(kAll, v.x, delta), __shfl_down_sync(kAll, v.y, delta),
      __shfl_down_sync(kAll, v.z, delta), __shfl_down_sync(kAll, v.w, delta));
}

// One block. Where x and o are 16-byte aligned the floats go as float4s,
// four loads of a thread started before its first store; what is left (a
// count that is no multiple of 4, or unaligned pointers) goes one by one.
__global__ void __launch_bounds__(kTrivialThreads)
    probe_trivial_kernel(const float* __restrict__ x, float* __restrict__ o,
                         int count) {
  constexpr int kT = kTrivialThreads;
  const bool aligned = ((reinterpret_cast<unsigned long long>(x) |
                         reinterpret_cast<unsigned long long>(o)) &
                        15ull) == 0;
  const int vecs = aligned ? count / 4 : 0;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(o);
  int k = threadIdx.x;
  for (; k + 3 * kT < vecs; k += 4 * kT) {
    const float4 a = x4[k], b = x4[k + kT], c = x4[k + 2 * kT],
                 d = x4[k + 3 * kT];
    o4[k] = twice(a);
    o4[k + kT] = twice(b);
    o4[k + 2 * kT] = twice(c);
    o4[k + 3 * kT] = twice(d);
  }
  for (; k < vecs; k += kT) o4[k] = twice(x4[k]);
  for (int j = 4 * vecs + threadIdx.x; j < count; j += kT) o[j] = 2.0f * x[j];
}

// grid (rows, planes), block (cols).
__global__ void probe_gridded_kernel(const float* __restrict__ x,
                                     float* __restrict__ o, int rows,
                                     int cols) {
  const long long k =
      (static_cast<long long>(blockIdx.y) * rows + blockIdx.x) * cols +
      threadIdx.x;
  o[k] = 2.0f * x[k];
}

// grid (planes).
__global__ void __launch_bounds__(kThreads)
    probe_prefetch_kernel(const int* __restrict__ idx,
                          const float* __restrict__ x, float* __restrict__ o,
                          int plane) {
  __shared__ int src;
  if (threadIdx.x == 0) src = idx[blockIdx.x];
  __syncthreads();
  const float* in = x + static_cast<long long>(src) * plane;
  float* out = o + static_cast<long long>(blockIdx.x) * plane;
  for (int k = threadIdx.x; k < plane; k += kThreads) out[k] = in[k] + 1.0f;
}

// grid (kStaticRows / kStaticBandRows), kStaticThreads; x has `pitch` floats
// per row (a multiple of 4), x and o 16-byte aligned. Each thread copies its
// chunks of 16 bytes into shared memory, waits for its own copy group and
// stores what it copied: no other thread reads it, so no block barrier.
__global__ void __launch_bounds__(kStaticThreads)
    probe_static_dma_kernel(const float* __restrict__ x, float* __restrict__ o,
                            int pitch) {
  constexpr int kVecs = kStaticCols / 4;  // chunks of a row
  constexpr int kChunks = kStaticBandRows * kVecs / kStaticThreads;
  static_assert(kStaticRows % kStaticBandRows == 0 &&
                    kStaticBandRows * kVecs % kStaticThreads == 0,
                "bands tile the window, chunks the band");
  __shared__ __align__(16) float4 win[kStaticBandRows * kVecs];
  const int r0 = blockIdx.x * kStaticBandRows;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int k = threadIdx.x + j * kStaticThreads;
    const int r = k / kVecs, c = 4 * (k % kVecs);
    const float* src = x + static_cast<long long>(kStaticRow0 + r0 + r) * pitch +
                       kStaticCol0 + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(win + k)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  float4* out = reinterpret_cast<float4*>(o) + r0 * kVecs;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int k = threadIdx.x + j * kStaticThreads;
    out[k] = win[k];
  }
}

// grid (rows / kDmaRows, planes), one warp; corners (planes, 2) int32; big
// has `width` floats per row. A block moves a band of kDmaRows rows: lane
// r < kDmaRows asks for row r; lane 0 waits for all of them on the mbarrier
// and sends the band, which is contiguous in o, back out in one bulk copy.
// Each block's copy in and copy out run one after the other, so short bands
// on many SMs (128 blocks of 8 KB here) finish sooner than long ones: bands
// of 32 rows took 0.0033 ms in a CUDA graph, of 16 rows 0.0025-0.0026, of 8
// rows 0.0023, and the warp's own 16-byte stores instead of the bulk copy
// out 0 to 0.0002 ms more at each height (NVIDIA H100 80GB HBM3, 700 W).
__global__ void __launch_bounds__(kDmaThreads)
    probe_dynamic_dma_kernel(const int* __restrict__ corners,
                             const float* __restrict__ big,
                             float* __restrict__ o, int rows, int width) {
  static_assert(kDmaRows <= kDmaThreads && kBandRows % kDmaRows == 0,
                "a lane per row of the band; bands tile the wrapper's");
  __shared__ __align__(128) float win[kDmaRows * kWindowCols];
  __shared__ __align__(8) unsigned long long bar_storage;
  const unsigned bar = smem_addr(&bar_storage);
  const int i = blockIdx.y, r0 = blockIdx.x * kDmaRows, lane = threadIdx.x;
  constexpr unsigned kRowBytes = kWindowCols * sizeof(float);
  if (lane == 0) {
    mbarrier_init(bar, 1);
    mbarrier_expect_tx(bar, kDmaRows * kRowBytes);
  }
  __syncwarp();
  if (lane < kDmaRows) {
    const int cy = corners[2 * i], cx = corners[2 * i + 1];
    bulk_copy(smem_addr(win + lane * kWindowCols),
              big + static_cast<long long>(cy + r0 + lane) * width + cx,
              kRowBytes, bar);
  }
  if (lane == 0) {
    mbarrier_wait(bar, 0);
    bulk_store(o + (static_cast<long long>(i) * rows + r0) * kWindowCols,
               smem_addr(win), kDmaRows * kRowBytes);
    bulk_store_wait();
  }
}

// Form (a) of probe_element_kernel: lane r of warp 0 asks for the widened
// span of row r by one bulk copy, all threads wait on the mbarrier, then each
// makes its values from shared memory, shifted by the lead. `src` is the
// band's first widened row.
__device__ __forceinline__ void element_staged(const float* __restrict__ src,
                                               float* __restrict__ dst,
                                               int width, int lead) {
  __shared__ __align__(128) float win[kElementRows * kElementPitch];
  __shared__ __align__(8) unsigned long long bar_storage;
  const unsigned bar = smem_addr(&bar_storage);
  const unsigned span_bytes = ((lead + kWindowCols + 3) & ~3) * sizeof(float);
  if (threadIdx.x == 0) {
    mbarrier_init(bar, 1);
    mbarrier_expect_tx(bar, kElementRows * span_bytes);
  }
  __syncthreads();
  if (threadIdx.x < kElementRows) {
    bulk_copy(smem_addr(win + threadIdx.x * kElementPitch),
              src + static_cast<long long>(threadIdx.x) * width, span_bytes,
              bar);
  }
  mbarrier_wait(bar, 0);
  if constexpr (kElementVectors) {
    constexpr int kVecsPerRow = kWindowCols / 4;
    for (int q = threadIdx.x; q < kElementRows * kVecsPerRow; q += kThreads) {
      const float* w = win + (q / kVecsPerRow) * kElementPitch + lead +
                       4 * (q % kVecsPerRow);
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(2.0f * w[0], 2.0f * w[1], 2.0f * w[2], 2.0f * w[3]);
    }
  } else {
    for (int k = threadIdx.x; k < kElementRows * kWindowCols; k += kThreads) {
      dst[k] = 2.0f * win[(k / kWindowCols) * kElementPitch + lead +
                          k % kWindowCols];
    }
  }
}

// Form (b): no shared memory. Each thread loads the 16-byte aligned float4s
// of its output's widened span, all before the first store, takes the next
// float4 from the next lane (the last lane of a row's half loads its own:
// the span's last float4, inside the row), and stores float4s. With
// kElementVectors false, 4-byte loads at the window's own start and 4-byte
// stores, a warp on 32 neighbouring values.
__device__ __forceinline__ void element_direct(const float* __restrict__ src,
                                               float* __restrict__ dst,
                                               int width, int lead) {
  if constexpr (kElementVectors) {
    constexpr int kVecsPerRow = kWindowCols / 4;  // a multiple of 32
    constexpr int kV = kElementRows * kVecsPerRow / kThreads;
    static_assert(kElementRows * kVecsPerRow % kThreads == 0,
                  "the band's float4s spread evenly");
    const bool last_lane = (threadIdx.x & 31) == 31;
    float4 a[kV], e[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int q = threadIdx.x + j * kThreads;
      const float4* row = reinterpret_cast<const float4*>(
          src + static_cast<long long>(q / kVecsPerRow) * width);
      a[j] = __ldg(row + q % kVecsPerRow);
      if (lead != 0 && last_lane) e[j] = __ldg(row + q % kVecsPerRow + 1);
    }
    float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      float4 b = a[j];
      if (lead != 0) {
        b = shfl_down(a[j], 1);
        if (last_lane) b = e[j];
      }
      out[threadIdx.x + j * kThreads] = twice(shifted(a[j], b, lead));
    }
  } else {
    constexpr int kS = kElementRows * kWindowCols / kThreads;
    static_assert(kElementRows * kWindowCols % kThreads == 0,
                  "the band's values spread evenly");
    float v[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int k = threadIdx.x + j * kThreads;
      v[j] = __ldg(src + static_cast<long long>(k / kWindowCols) * width +
                   lead + k % kWindowCols);
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) dst[threadIdx.x + j * kThreads] = 2.0f * v[j];
  }
}

// grid (rows / kElementRows, planes), kThreads; big has `width` floats per
// row (a multiple of 4) and is 16-byte aligned, as is o. With kFromIndex
// the starts come from corners (planes, 2) int32, else they are
// (kElementStepY i, kElementStepX i), whose lead is 0.
template <bool kFromIndex>
__global__ void __launch_bounds__(kThreads)
    probe_element_kernel(const int* __restrict__ corners,
                         const float* __restrict__ big, float* __restrict__ o,
                         int rows, int width) {
  static_assert(kBandRows % kElementRows == 0 && kElementRows <= 32,
                "bands tile the wrappers' rows; a lane per staged row");
  const int i = blockIdx.y, r0 = blockIdx.x * kElementRows;
  const int cy = kFromIndex ? __ldg(corners + 2 * i) : kElementStepY * i;
  const int cx = kFromIndex ? __ldg(corners + 2 * i + 1) : kElementStepX * i;
  const int lead = kFromIndex ? cx & 3 : 0;
  const float* src = big + static_cast<long long>(cy + r0) * width + cx - lead;
  float* dst = o + (static_cast<long long>(i) * rows + r0) * kWindowCols;
  if constexpr (kElementStaged) {
    element_staged(src, dst, width, lead);
  } else {
    element_direct(src, dst, width, lead);
  }
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// o = 2 x, count floats, one block.
extern "C" int tike_probe_trivial(const void* x, void* o, int count,
                                  void* stream) {
  probe_trivial_kernel<<<1, kTrivialThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), count);
  return static_cast<int>(cudaGetLastError());
}

// o = 2 x over (planes, rows, cols); cols <= 1024.
extern "C" int tike_probe_gridded(const void* x, void* o, int planes, int rows,
                                  int cols, void* stream) {
  probe_gridded_kernel<<<dim3(rows, planes), cols, 0, as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// o[i] = x[idx[i]] + 1 for planes of `plane` floats.
extern "C" int tike_probe_prefetch(const void* idx, const void* x, void* o,
                                   int planes, int plane, void* stream) {
  probe_prefetch_kernel<<<planes, kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(x),
      static_cast<float*>(o), plane);
  return static_cast<int>(cudaGetLastError());
}

// o (128, 128) = x[0:128, 0:128]; x has `pitch` floats per row.
extern "C" int tike_probe_static_dma(const void* x, void* o, int pitch,
                                     void* stream) {
  probe_static_dma_kernel<<<kStaticRows / kStaticBandRows, kStaticThreads, 0,
                            as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), pitch);
  return static_cast<int>(cudaGetLastError());
}

// o (planes, rows, 256) = the windows of big (width floats per row) at
// corners (planes, 2); rows a multiple of kBandRows; o 16-byte aligned.
extern "C" int tike_probe_dynamic_dma(const void* corners, const void* big,
                                      void* o, int planes, int rows, int width,
                                      void* stream) {
  probe_dynamic_dma_kernel<<<dim3(rows / kDmaRows, planes), kDmaThreads, 0,
                             as_stream(stream)>>>(
      static_cast<const int*>(corners), static_cast<const float*>(big),
      static_cast<float*>(o), rows, width);
  return static_cast<int>(cudaGetLastError());
}

// o (planes, rows, 256) = 2 x the windows of big at corners (planes, 2), or
// at (8 i, 16 i) when corners is NULL.
extern "C" int tike_probe_element(const void* corners, const void* big,
                                  void* o, int planes, int rows, int width,
                                  void* stream) {
  const dim3 grid(rows / kElementRows, planes);
  if (corners == nullptr) {
    probe_element_kernel<false><<<grid, kThreads, 0, as_stream(stream)>>>(
        nullptr, static_cast<const float*>(big), static_cast<float*>(o), rows,
        width);
  } else {
    probe_element_kernel<true><<<grid, kThreads, 0, as_stream(stream)>>>(
        static_cast<const int*>(corners), static_cast<const float*>(big),
        static_cast<float*>(o), rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

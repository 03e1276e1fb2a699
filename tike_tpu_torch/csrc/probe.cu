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
//     16-byte cp.async (Ampere's asynchronous copy), then out;
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
//     Pallas's pl.Element blocks start at any element; a bulk copy cannot.
//     These kernels copy each row's span from the start rounded down to 16
//     bytes to its end rounded up (at most 3 floats more on each side, inside
//     the row, as the row width is a multiple of 4) by cp.async.bulk, and
//     read it back shifted by the lead. [8i, 16i] needs no shift on the
//     card (16i floats is a multiple of 64 bytes), [9i+3, 17i+5] does.
// Each kernel works on bands of kBandRows rows, so a block's shared memory
// stays under the 48 KB that needs no opt-in.
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTrivialThreads = 1024;  // one block, the most it can hold
constexpr int kDmaThreads = 32;        // one warp: a lane per row of a band
constexpr int kDmaRows = 8;            // rows of a dynamic_dma band
constexpr int kBandRows = 32;
constexpr int kStaticRows = 128, kStaticCols = 128;  // x[0:128, 0:128]
constexpr int kStaticRow0 = 0, kStaticCol0 = 0;
constexpr int kWindowCols = 256;                     // big[.., +256]
constexpr int kElementStepY = 8, kElementStepX = 16;  // element_static
constexpr int kElementPitch = kWindowCols + 4;         // room for the lead

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

// grid (kStaticRows / kBandRows); x has `pitch` floats per row.
__global__ void __launch_bounds__(kThreads)
    probe_static_dma_kernel(const float* __restrict__ x, float* __restrict__ o,
                            int pitch) {
  __shared__ __align__(16) float win[kBandRows * kStaticCols];
  constexpr int kVecs = kStaticCols / 4;
  const int r0 = blockIdx.x * kBandRows;
  for (int k = threadIdx.x; k < kBandRows * kVecs; k += kThreads) {
    const int r = k / kVecs, c = 4 * (k % kVecs);
    const float* src = x + static_cast<long long>(kStaticRow0 + r0 + r) * pitch +
                       kStaticCol0 + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(win + r * kStaticCols + c)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int k = threadIdx.x; k < kBandRows * kStaticCols; k += kThreads) {
    o[static_cast<long long>(r0) * kStaticCols + k] = win[k];
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

// grid (rows / kBandRows, planes). With kFromIndex the starts come from
// corners (planes, 2) int32, else they are (kElementStepY i, kElementStepX i).
template <bool kFromIndex>
__global__ void __launch_bounds__(kThreads)
    probe_element_kernel(const int* __restrict__ corners,
                         const float* __restrict__ big, float* __restrict__ o,
                         int rows, int width) {
  __shared__ __align__(128) float win[kBandRows * kElementPitch];
  __shared__ __align__(8) unsigned long long bar_storage;
  const unsigned bar = smem_addr(&bar_storage);
  const int i = blockIdx.y, r0 = blockIdx.x * kBandRows;
  const int cy = kFromIndex ? corners[2 * i] : kElementStepY * i;
  const int cx = kFromIndex ? corners[2 * i + 1] : kElementStepX * i;
  // The row span [cx, cx + 256) widened to 16-byte boundaries.
  const int c0 = cx & ~3, lead = cx - c0;
  const unsigned span_bytes = ((lead + kWindowCols + 3) & ~3) * sizeof(float);
  if (threadIdx.x == 0) mbarrier_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbarrier_expect_tx(bar, kBandRows * span_bytes);
    for (int r = 0; r < kBandRows; ++r) {
      bulk_copy(smem_addr(win + r * kElementPitch),
                big + static_cast<long long>(cy + r0 + r) * width + c0,
                span_bytes, bar);
    }
  }
  mbarrier_wait(bar, 0);
  float* out = o + (static_cast<long long>(i) * rows + r0) * kWindowCols;
  for (int k = threadIdx.x; k < kBandRows * kWindowCols; k += kThreads) {
    const int r = k / kWindowCols, c = k % kWindowCols;
    out[k] = 2.0f * win[r * kElementPitch + lead + c];
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
  probe_static_dma_kernel<<<kStaticRows / kBandRows, kThreads, 0,
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
  const dim3 grid(rows / kBandRows, planes);
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

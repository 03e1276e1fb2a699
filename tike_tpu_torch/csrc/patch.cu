// Bilinear patch gather (patch_fwd) and its adjoint (patch_adj) for NVIDIA
// Hopper, built for sm_90a with nvcc into a shared library with a plain C
// interface (loaded by tike_tpu_torch/kernels.py through ctypes).
//
// What they replace. The JAX package's solvers compute these two operators
// with XLA's gather and scatter (tike_tpu/ops/patch.py); its Pallas TPU
// kernels in tike_tpu/ops/patch_pallas.py compute the same operators as
// kernels, and these are their counterparts:
//   - patch_fwd_pallas_elem (_patch_fwd_elem_kernel, :68-116) and
//     patch_fwd_pallas (_patch_fwd_kernel, :153-186) -> patch_fwd_kernel;
//   - patch_adj_pallas (_patch_adj_kernel, :244-290) -> patch_adj_kernel.
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
// What bounds them on this card: bytes. Each must move at least the N P^2
// patch values (written by the forward, read by the adjoint), the H W image
// (read once by the forward, written once by the adjoint, plus read once
// when the adjoint starts from an initial image) and the 8 N bytes of
// positions. At the main path's shapes (1,000 x 128^2 patches of a 1500^2
// complex64 object) that is 149.08 MB, 0.0445 ms at 3.35 TB/s; the
// arithmetic (16 flops per complex patch value) is under a tenth of that.
// Of the image the forward needs only the pixels its windows touch (about
// a sixth of it under a compact batch), and the adjoint needs only the
// patch values whose taps land inside the image (ops/patch.py,
// needed_values).
// A direct port, one thread per pixel reading four neighbours or adding
// with float atomics, moves about four times those bytes through L2 and,
// in the adjoint, makes 2 atomics per window pixel that contend where
// windows overlap.
//
// patch_fwd_kernel. A block of kFwdThreads makes one band of kFwdRows output
// rows of one patch. It copies the band's (rows + 1) x (P + 1) window into
// shared memory with 8-byte (4 for float32) cp.async, so each window value
// crosses L2 about once (1.06 x the output); an element outside the image
// is copied with a source size of 0, which writes zeros, so the blend needs
// no bounds checks. The SM's other resident blocks (one stage each) overlap
// one band's copy with another's blend: a persistent loop over bands with
// two stages per block measured slower on the H100. Each thread blends two
// adjacent outputs from shared memory and writes them with one 16-byte (8
// for float32) streaming store (__stcs, evict-first), so the output does
// not push the image out of L2; an odd P stores one value at a time.
//
// patch_adj_kernel. The gather form of the transpose: a block owns a
// kAdjTile x kAdjTile tile of the image and writes each of its pixels once,
// so there are no atomics and no memset of the output. The block scans the
// positions, kScanAhead chunks of its threads per round; the windows that
// meet the tile are compacted in ascending patch index (a warp ballot and a
// block prefix sum) into a list in shared memory. When a round would
// overflow the list, the list is accumulated and emptied first. The block
// is kAdjSplit groups of kAdjThreads; group g takes the g-th of kAdjSplit
// contiguous shares of each list, so a tile under a compact batch (a
// hundred windows or more) has twice the warps on it. In a group each
// thread owns a column strip of kAdjRows pixels of the tile in registers;
// for each patch of its share, in order, each warp whose strip the window
// meets loads the patch values the strip needs straight from global memory
// into registers (the read-only path; column lx + 1 is an L1 hit of the
// next lane's column lx) and adds the spread window value (the four
// weighted taps in a fixed order) to each pixel. Nothing synchronises the
// warps while they accumulate; at the end group 0 adds the other groups'
// sums, in group order, through shared memory. Staging each patch's part
// of the tile in shared memory with cp.async first, behind block barriers,
// measured slower on the H100 (PERF.md, section 6). The image
// is initial + (share 0 in ascending order) + (share 1 in ascending order):
// a fixed order for given inputs, so the result is deterministic, bitwise
// the same run after run, as the TPU kernel's sequential grid was. The
// patches are read about (33/32)^2 = 1.06 x (the one-pixel seams between
// tiles).
//
// Each launcher allocates nothing, launches on the stream it is given, and
// returns a cudaError_t; the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdRows = 16;
// Shared memory a forward block may take; wider patches get narrower bands.
constexpr size_t kFwdSmemBudget = 96 * 1024;

constexpr int kAdjThreads = 256;  // of one group: the tile
constexpr int kAdjSplit = 2;  // groups, each with its share
constexpr int kAdjBlock = kAdjThreads * kAdjSplit;
constexpr int kAdjBlockWarps = kAdjBlock / 32;
constexpr int kAdjTile = 32;
// Blocks per SM the compiler sizes registers for (64 registers a thread).
constexpr int kAdjMinBlocks = 2;
constexpr int kScanAhead = 4;  // scan chunks per round
// Listed patches held at once: at least one round of the scan.
constexpr int kAdjList =
    kScanAhead * kAdjBlock > 1024 ? kScanAhead * kAdjBlock : 1024;
constexpr int kAdjGroups = kAdjThreads / kAdjTile;  // row groups of the tile
constexpr int kAdjRows = kAdjTile / kAdjGroups;     // rows each thread owns
static_assert(kAdjTile % 32 == 0 && kAdjThreads % kAdjTile == 0,
              "a warp must lie in one row group of the tile");
static_assert(kAdjTile % kAdjGroups == 0, "row groups must tile the tile");
static_assert(kAdjList >= kScanAhead * kAdjBlock,
              "one round of the scan must fit in the list");

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

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

template <typename T>
__device__ __forceinline__ T blend(float w00, T a, float w01, T b, float w10,
                                   T c, float w11, T d) {
  T v = scale_add(w00, a, zero_value<T>());
  v = scale_add(w01, b, v);
  v = scale_add(w10, c, v);
  return scale_add(w11, d, v);
}

// Two adjacent values of T as one vector: float4 for complex, float2 for
// float32.
template <typename T>
struct PairOf;
template <>
struct PairOf<float2> {
  using type = float4;
};
template <>
struct PairOf<float> {
  using type = float2;
};

__device__ __forceinline__ float4 make_pair(float2 a, float2 b) {
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 make_pair(float a, float b) {
  return make_float2(a, b);
}
__device__ __forceinline__ float2 pair_first(float4 v) {
  return make_float2(v.x, v.y);
}
__device__ __forceinline__ float2 pair_second(float4 v) {
  return make_float2(v.z, v.w);
}
__device__ __forceinline__ float pair_first(float2 v) { return v.x; }
__device__ __forceinline__ float pair_second(float2 v) { return v.y; }

// Copy kBytes from global to shared memory asynchronously; with ``inside``
// false nothing is read and the destination is zero-filled (``gmem`` must
// still be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool inside) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = inside ? kBytes : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem), "n"(kBytes), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// patches[k, y, x] = the four bilinear taps of image around
// (floor(pos[k]) + (y, x)), for output rows [band * rows, band * rows +
// nrows) of patch k, block (k * bands + band): the window rows are staged in
// shared memory, row stride ``stride`` (even, so pair loads are aligned).
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    patch_fwd_kernel(const T* __restrict__ image,
                     const float2* __restrict__ positions,
                     T* __restrict__ patches, int h, int w, int p, int rows) {
  using V = typename PairOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);
  const int stride = (p + 2) & ~1;
  const int bands = (p + rows - 1) / rows;
  const int k = blockIdx.x / bands;
  const int band = blockIdx.x - k * bands;
  const float2 q = positions[k];
  const float fly = floorf(q.x);
  const float flx = floorf(q.y);
  const int nrows = min(rows, p - band * rows);

  // Stage the nrows + 1 window rows of P + 1 values; zeros off the image.
  const int r0 = static_cast<int>(fly) + band * rows;
  const int c0 = static_cast<int>(flx);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i <= nrows; i += kFwdWarps) {
    const int r = r0 + i;
    const bool row_in = r >= 0 && r < h;
    const T* src_row = image + static_cast<size_t>(row_in ? r : 0) * w;
    for (int j = lane; j <= p; j += 32) {
      const int c = c0 + j;
      const bool in = row_in && c >= 0 && c < w;
      cp_async_zfill<static_cast<int>(sizeof(T))>(buf + i * stride + j,
                                                  in ? src_row + c : image,
                                                  in);
    }
  }
  cp_async_commit();

  const float fy = q.x - fly;
  const float fx = q.y - flx;
  const float w00 = (1.0f - fy) * (1.0f - fx);
  const float w01 = (1.0f - fy) * fx;
  const float w10 = fy * (1.0f - fx);
  const float w11 = fy * fx;
  const int half = (p + 1) >> 1;  // output pairs per row
  const bool even = (p & 1) == 0;
  T* out = patches + (static_cast<size_t>(k) * p + band * rows) * p;
  cp_async_wait_all();
  __syncthreads();

  for (int e = threadIdx.x; e < nrows * half; e += kFwdThreads) {
    const int y = e / half;
    const int x = 2 * (e - y * half);
    const T* top = buf + y * stride + x;
    const T* bot = top + stride;
    const V t01 = *reinterpret_cast<const V*>(top);
    const V b01 = *reinterpret_cast<const V*>(bot);
    const T a0 = pair_first(t01), a1 = pair_second(t01);
    const T c0 = pair_first(b01), c1 = pair_second(b01);
    const T v0 = blend(w00, a0, w01, a1, w10, c0, w11, c1);
    T* dst = out + static_cast<size_t>(y) * p + x;
    if (x + 1 < p) {
      const T v1 = blend(w00, a1, w01, top[2], w10, c1, w11, bot[2]);
      if (even) {
        __stcs(reinterpret_cast<V*>(dst), make_pair(v0, v1));
      } else {
        __stcs(dst, v0);
        __stcs(dst + 1, v1);
      }
    } else {
      __stcs(dst, v0);
    }
  }
}

// What one warp needs of one patch for its strip: the patch values at the
// strip's rows ly0 + [0, kAdjRows] and columns lx, lx + 1 of the tile's
// (kAdjTile + 1)^2 block, where block[i][j] = patch[ty0 - cy - 1 + i][tx0 -
// cx - 1 + j] (zero outside the patch), and the weights. ``any`` is false
// (for the whole warp) when the window misses the warp's strip.
template <typename T>
struct AdjTaps {
  T l[kAdjRows + 1];
  T r[kAdjRows + 1];
  float w00, w01, w10, w11;
  bool any;
};

template <typename T>
__device__ __forceinline__ void adj_load(const T* __restrict__ patches,
                                         const float2* __restrict__ positions,
                                         int k, int ty0, int tx0, int p,
                                         int ly0, int lx, AdjTaps<T>& t) {
  const float2 q = positions[k];
  const float fly = floorf(q.x);
  const float flx = floorf(q.y);
  // Patch row of the strip's first block row, and patch column of block
  // column lx and of the warp's first column.
  const int py = ty0 + ly0 - static_cast<int>(fly) - 1;
  const int px = tx0 + lx - static_cast<int>(flx) - 1;
  const int px_warp = px - (lx & 31);
  t.any = py + kAdjRows >= 0 && py < p && px_warp + 32 >= 0 && px_warp < p;
  if (!t.any) return;
  const float fy = q.x - fly;
  const float fx = q.y - flx;
  t.w00 = (1.0f - fy) * (1.0f - fx);
  t.w01 = (1.0f - fy) * fx;
  t.w10 = fy * (1.0f - fx);
  t.w11 = fy * fx;
  const bool col_l = px >= 0 && px < p;
  const bool col_r = px + 1 >= 0 && px + 1 < p;
  const T* src = patches + static_cast<size_t>(k) * p * p +
                 static_cast<ptrdiff_t>(py) * p + px;
  const T zero = zero_value<T>();
#pragma unroll
  for (int i = 0; i <= kAdjRows; ++i) {
    const bool row = py + i >= 0 && py + i < p;
    const T* at = src + static_cast<ptrdiff_t>(i) * p;
    t.l[i] = row && col_l ? __ldg(at) : zero;
    t.r[i] = row && col_r ? __ldg(at + 1) : zero;
  }
}

// Pixel (ly0 + i, lx) takes block[ly + 1][lx + 1] with w00, [ly + 1][lx]
// with w01, [ly][lx + 1] with w10 and [ly][lx] with w11.
template <typename T>
__device__ __forceinline__ void adj_add(const AdjTaps<T>& t,
                                        T (&acc)[kAdjRows]) {
  if (!t.any) return;
#pragma unroll
  for (int i = 0; i < kAdjRows; ++i)
    acc[i] = add(acc[i], blend(t.w00, t.r[i + 1], t.w01, t.l[i + 1], t.w10,
                               t.r[i], t.w11, t.l[i]));
}

// Add the listed patches list[0, count) to the strip, in order.
template <typename T>
__device__ __forceinline__ void adj_process(
    const T* __restrict__ patches, const float2* __restrict__ positions,
    const int* list, int count, int ty0, int tx0, int p, int ly0, int lx,
    T (&acc)[kAdjRows]) {
  AdjTaps<T> a;
  for (int j = 0; j < count; ++j) {
    adj_load(patches, positions, list[j], ty0, tx0, p, ly0, lx, a);
    adj_add(a, acc);
  }
}

// image[tile] = initial[tile] (or 0) + the spread windows of every patch
// that meets the tile, added in ascending patch index; one block per tile.
template <typename T>
__global__ void __launch_bounds__(kAdjBlock, kAdjMinBlocks)
    patch_adj_kernel(const T* __restrict__ patches,
                     const float2* __restrict__ positions,
                     const T* __restrict__ initial, T* __restrict__ image,
                     int n, int h, int w, int p) {
  __shared__ int list[kAdjList];
  __shared__ int warp_hits[kScanAhead][kAdjBlockWarps];
  // The partial sums of groups 1, 2, ... for group 0 to add in order.
  __shared__ __align__(16) unsigned char partial_raw
      [sizeof(T) * (kAdjSplit > 1 ? kAdjSplit - 1 : 1) * kAdjTile * kAdjTile];
  T* const partial = reinterpret_cast<T*>(partial_raw);

  const int ty0 = blockIdx.y * kAdjTile;
  const int tx0 = blockIdx.x * kAdjTile;
  const int ty1 = min(ty0 + kAdjTile, h) - 1;  // last row inside the image
  const int tx1 = min(tx0 + kAdjTile, w) - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x / kAdjThreads;
  const int lx = threadIdx.x % kAdjTile;
  const int ly0 = (threadIdx.x % kAdjThreads / kAdjTile) * kAdjRows;
  const int gx = tx0 + lx;

  T acc[kAdjRows];
#pragma unroll
  for (int i = 0; i < kAdjRows; ++i) {
    const int gy = ty0 + ly0 + i;
    acc[i] = (group == 0 && initial != nullptr && gy < h && gx < w)
                 ? initial[static_cast<size_t>(gy) * w + gx]
                 : zero_value<T>();
  }

  // Scan kScanAhead chunks of positions per round: one ballot per chunk,
  // one barrier to share the warps' counts, then each hit goes to its
  // place in the list in ascending index. When a round would overflow the
  // list, the list is accumulated and emptied, and the round is scanned
  // again.
  const unsigned lanes_below = (1u << lane) - 1u;
  int base = 0;
  for (;;) {
    int count = 0;
    while (base < n) {
      float2 q[kScanAhead];
#pragma unroll
      for (int a = 0; a < kScanAhead; ++a) {
        const int k = base + a * kAdjBlock + threadIdx.x;
        q[a] = k < n ? positions[k] : make_float2(0.0f, 0.0f);
      }
      unsigned ballot[kScanAhead];
#pragma unroll
      for (int a = 0; a < kScanAhead; ++a) {
        const int k = base + a * kAdjBlock + threadIdx.x;
        const int cy = static_cast<int>(floorf(q[a].x));
        const int cx = static_cast<int>(floorf(q[a].y));
        ballot[a] = __ballot_sync(0xffffffffu, k < n && cy <= ty1 &&
                                                   cy + p >= ty0 &&
                                                   cx <= tx1 && cx + p >= tx0);
        if (lane == 0) warp_hits[a][warp] = __popc(ballot[a]);
      }
      __syncthreads();
      int offset[kScanAhead];
      int total = 0;
#pragma unroll
      for (int a = 0; a < kScanAhead; ++a) {
        int before = 0;
        int chunk = 0;
#pragma unroll
        for (int i = 0; i < kAdjBlockWarps; ++i) {
          const int c = warp_hits[a][i];
          before += i < warp ? c : 0;
          chunk += c;
        }
        offset[a] = total + before;
        total += chunk;
      }
      if (count + total > kAdjList) break;  // block-uniform
#pragma unroll
      for (int a = 0; a < kScanAhead; ++a) {
        if ((ballot[a] >> lane) & 1u)
          list[count + offset[a] + __popc(ballot[a] & lanes_below)] =
              base + a * kAdjBlock + threadIdx.x;
      }
      count += total;
      base += kScanAhead * kAdjBlock;
      __syncthreads();
    }
    // Group g adds the g-th of kAdjSplit contiguous shares of the list.
    adj_process(patches, positions, list + count * group / kAdjSplit,
                count * (group + 1) / kAdjSplit - count * group / kAdjSplit,
                ty0, tx0, p, ly0, lx, acc);
    if (base >= n) break;
    __syncthreads();
  }

  if (kAdjSplit > 1) {
    const int at = (ly0 * kAdjTile + lx);
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < kAdjRows; ++i)
        partial[(group - 1) * kAdjTile * kAdjTile + at + i * kAdjTile] = acc[i];
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 1; g < kAdjSplit; ++g) {
#pragma unroll
      for (int i = 0; i < kAdjRows; ++i)
        acc[i] = add(acc[i], partial[(g - 1) * kAdjTile * kAdjTile + at +
                                     i * kAdjTile]);
    }
  }

  if (gx < w) {
#pragma unroll
    for (int i = 0; i < kAdjRows; ++i) {
      const int gy = ty0 + ly0 + i;
      if (gy < h) image[static_cast<size_t>(gy) * w + gx] = acc[i];
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const T* image, const float2* positions, T* patches,
                       int n, int h, int w, int p, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || h < 1 || w < 1 || p < 1) return cudaErrorInvalidValue;
  const size_t stride = static_cast<size_t>((p + 2) & ~1);
  int rows = kFwdRows;
  while (rows > 1 && (rows + 1) * stride * sizeof(T) > kFwdSmemBudget)
    rows /= 2;
  const size_t smem = (rows + 1) * stride * sizeof(T);
  const long long blocks =
      static_cast<long long>(n) * ((p + rows - 1) / rows);
  if (smem > kFwdSmemBudget || blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      patch_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  patch_fwd_kernel<T><<<static_cast<unsigned>(blocks), kFwdThreads, smem,
                        stream>>>(image, positions, patches, h, w, p, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_adj(const T* patches, const float2* positions,
                       const T* initial, T* image, int n, int h, int w, int p,
                       cudaStream_t stream) {
  if (h == 0 || w == 0) return cudaSuccess;
  if (n < 0 || h < 0 || w < 0 || p < 1) return cudaErrorInvalidValue;
  const dim3 grid((w + kAdjTile - 1) / kAdjTile, (h + kAdjTile - 1) / kAdjTile);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  patch_adj_kernel<T><<<grid, kAdjBlock, 0, stream>>>(
      patches, positions, initial, image, n, h, w, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tike_patch_fwd(const void* image, const void* positions,
                              void* patches, int n, int h, int w, int p,
                              int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pos = static_cast<const float2*>(positions);
  cudaError_t err;
  if (channels == 2) {
    err = launch_fwd(static_cast<const float2*>(image), pos,
                     static_cast<float2*>(patches), n, h, w, p, s);
  } else if (channels == 1) {
    err = launch_fwd(static_cast<const float*>(image), pos,
                     static_cast<float*>(patches), n, h, w, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// ``initial`` may be null (the image starts from zeros); ``image`` is
// written whole and may not alias ``initial``.
extern "C" int tike_patch_adj(const void* patches, const void* positions,
                              const void* initial, void* image, int n, int h,
                              int w, int p, int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pos = static_cast<const float2*>(positions);
  cudaError_t err;
  if (channels == 2) {
    err = launch_adj(static_cast<const float2*>(patches), pos,
                     static_cast<const float2*>(initial),
                     static_cast<float2*>(image), n, h, w, p, s);
  } else if (channels == 1) {
    err = launch_adj(static_cast<const float*>(patches), pos,
                     static_cast<const float*>(initial),
                     static_cast<float*>(image), n, h, w, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

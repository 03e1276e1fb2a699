// The Bucket laminography operator for NVIDIA Hopper: the forward projection
// of voxels onto the tilted detector plane (bucket_fwd_kernel) and its
// adjoint, the gather of the plane back to each voxel (bucket_adj_kernel).
// Built for sm_90a with nvcc into a shared library with a plain C interface
// (loaded by tike_tpu_torch/kernels.py through ctypes).
//
// What they replace. The JAX package has no Pallas kernel for this: it
// writes the operator as XLA scatter and gather code (tike_tpu/ops/
// bucket.py:61-133), one batched scatter-add or gather of all voxels per
// (angle, sub-voxel offset). The original tike ran it as CUDA
// (bucket.cu:66-144).
//
// Semantics (tike_tpu/ops/bucket.py). Each voxel g has integer coordinates
// (g0, g1, g2), origin-centred (make_grid), and a complex value u[g]. It is
// sampled at precision^3 points p = g + (c_i, c_j, c_k), c_i = (i + 0.5) /
// precision, in the order (i, j, k) with k fastest. For angle t the point is
// projected onto the plane through the origin with normal (nx, ny, nz), and
// its in-plane coordinates (y, z) pick the cell
//     ((floor(y) + n/2) mod n, (floor(z) + n/2) mod n)
// of an n x n plane (the mod a floor-mod: never negative). The forward adds
// u[g] / precision^3 to that cell of plane t; the adjoint sums, over the
// angles (outer) and the offsets (inner), the plane value at that cell times
// 1 / precision^3.
//
// One ulp in y moves floor(y) by a whole cell, so every point must land in
// the cell the plain version picks, which the JAX package's must equal. So
// the kernels compute each point in the JAX package's order of float32
// operations, each rounded on its own (__fmul_rn / __fadd_rn: nvcc contracts
// a multiply and an add into an FMA by default, and the build flags are
// shared with the other sources):
//     d  = (p0 nx + p1 ny) + p2 nz
//     px = p0 - d nx,  py = p1 - d ny,  pz = p2 - d nz
//     y  = (st px + (cq ct) py) + (sq ct) pz
//     z  = (-sq) py + cq pz
// The trigonometry of each angle comes from the host as the first 8 columns
// of one row of a (T, 12) float32 table, (nx, ny, nz, st, cq ct, sq ct, -sq,
// cq) = (ct, -(cq st), -(sq st), st, cq ct, sq ct, -sq, cq), each cos and sin
// the float64 value of the float32 angle rounded to float32 and each product
// that of two such float32 values rounded once (tike_tpu_torch/ops/
// bucket.py::bucket_trig); the plain version reads the same table. The
// sub-voxel offsets c_i come from the host too (bucket_offsets: numpy's
// float64 quotient rounded to float32), the first kParamOffsets in the
// kernel's parameters; past those, a precision's offsets are computed in the
// kernel the same way (offset_at).
//
// What bounds them on this card: at 128^3 voxels, 64 angles and precision 3
// (laminography's default eps of 1e-1) each kernel projects 3.6e9 points,
// against 25 MB of volume and planes (7.5 us at 3.35 TB/s). Each point takes
// 15 rounded float32 operations for its (y, z) once everything that does
// not change within a voxel's row of points is hoisted (1 for d, 6 for px,
// py, pz, 5 for y, 3 for z), the adjoint's 4 more for its rounded products
// and sums, and two floors. Rounded on its own, each operation is one
// instruction of the FP32 pipe (128 a clock on each of 132 SMs: 33.5e12 a
// second at 1.98 GHz); a floor is one add on that pipe (below) or one
// conversion (16 a clock an SM). So the operations bound both, at 1.6-2.1
// ms (ops/bucket.py::roofline), and every integer instruction a point
// spends on its cell or on memory comes on top, on the same issue slots.
//
// The design (the lattice, grid == NULL, which the solver runs, whole or as
// an x-slab of rows x0 .. x0 + rows - 1 of axis 0, as a mesh's shards own
// it: the tiles are counted and placed from row x0 and cut at the slab's
// last row, and the window columns of the table, relative to a tile's
// corner, serve any slab unchanged):
//   - cells without a floor-mod. floor(y) is the bit pattern of
//     __fadd_rd(y, 1.5 2^23) less that of 1.5 2^23 (exact for |y| < 2^22,
//     which a lattice of n <= 46340 keeps), one FP32 add. A block owns a
//     tile of kTile^3 voxels, one a thread. For each angle the tile's points
//     land in a window of the plane whose extent the host computes per angle
//     (table columns 8-11: the lowest y and z of a tile's points relative to
//     its lowest corner, less a margin, and the window's rows and columns;
//     bucket_trig), the same for every tile; the kernel places it from the
//     tile's lowest corner (window_of). A point's window row and column are
//     then its round-down bits less the window's: two integer subtractions
//     and an unsigned compare each, no wrap. Only the window's own rows and
//     columns wrap, where it meets the plane, by a floor-mod: a window cell
//     pays it, not a point (one compare-and-add would not do: the windows
//     of the cut edge tiles reach past [-n, 2n)). A point outside its
//     window (none, if the host's extents are right) adds 1 to a device
//     counter and takes the plain global path, so the result stays right.
//   - bucket_adj_kernel: the block loops over all angles; each angle's
//     window (a few hundred cells) is copied into shared memory by 8-byte
//     cp.async, kStages windows in flight so that the copies of the next
//     angles land while angle t gathers (one block barrier an angle), and
//     the gathers read shared memory: no longer up to 32 L1 wavefronts for
//     a warp's scattered __ldg. A point's index is clamped into the buffer
//     and a flag kept of any point outside its window, so the loop has no
//     branch; a flagged voxel is summed again from the planes at the end
//     (gather_from_planes). Each voxel sums angles outer and offsets inner,
//     each product and sum rounded on its own: bitwise equal to the plain
//     version, and two launches agree. One block an SM, so that the 27
//     unrolled points of precision 3 do not spill.
//   - bucket_fwd_kernel: a block owns (tile, a group of angles). For each
//     angle the block's points go into its window in shared memory: at
//     precisions 3-5 each thread counts its voxel's points in the 3 x 3 box
//     of cells they fall in (9 counts of kCountBits bits in 64, one shift
//     and add a point, no branch) and adds count x (weight u) once a cell of
//     the box; other precisions add a point at a time. This card has no
//     shared float atomic add (atomicAdd compiles to a compare-and-swap
//     loop, ATOMS.CAST.SPIN), so the window has kWindowCopies copies, a
//     warp adding to one, and a warp's voxels spread over the tile, which
//     keeps the loops' retries down. These adds still take about half the
//     forward's time at full width (kernel_sweep --source bucket: the
//     variant without them); issuing a box row's compare-and-swaps
//     together, and binning the voxels by box with integer atomics so that
//     one thread sums each window cell, were both slower. Then each nonzero
//     window cell (its
//     copies summed) goes to the plane with one float2 atomicAdd (sm_90),
//     into planes the entry point zeroes first. The global atomics fall
//     from one a point (3.6e9 a projection) to at most one a window cell.
//     The atomics' order varies from launch to launch, so the last bits of
//     a cell do too: not bitwise repeatable, and a count's product stands
//     for its repeated sum within the rounding bound of the plain version's
//     sums (tests/_torch_bucket_cases.py::fwd_rounding_ratio).
// Precisions 1-4 compile with the point loops unrolled; others take the same
// kernels with runtime loops.
//
// A caller's grid (grid != NULL) keeps the one-thread-per-voxel form
// (bucket_*_voxel_kernel: a thread per (voxel, angle) and float2 atomics in
// the forward, a thread per voxel and __ldg gathers in the adjoint), with
// the offsets from the table and each point's cell by a floor and a
// floor-mod.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // the voxel kernels' block
constexpr int kTile = 8;           // a tile is kTile^3 voxels, one a thread
constexpr int kTileThreads = kTile * kTile * kTile;
// Windows the adjoint keeps in flight: angle t gathers while the copies of
// angles t + 1 .. t + kStages - 1 land.
constexpr int kStages = 4;
// Blocks of the adjoint and of the forward resident on an SM: at 1 a
// thread may use 128 registers (at 2, 64, and the adjoint's unrolled points
// spill).
constexpr int kAdjBlocks = 1;
constexpr int kFwdBlocks = 2;
// The forward at precisions 3-5 counts a voxel's points in each cell of
// its 3 x 3 box (kCountBits bits a cell, 9 cells in 64 bits) and adds
// count x value once a cell; else each point adds its value.
constexpr bool kCountCells = true;
constexpr int kCountBits = 7;
// The forward's window has kWindowCopies copies, warp w adding to copy
// w % kWindowCopies, summed in order when the window is flushed: fewer
// warps contend for a cell's shared atomic (a compare-and-swap loop on this
// card).
constexpr int kWindowCopies = 4;
// Whether a warp's 32 voxels spread over the tile (2 apart on axes 0 and
// 1, 4 on axis 2), so that their cells and boxes seldom meet (the forward's
// atomics), or lie in 4 rows of 8 consecutive voxels on axis 2 (the
// adjoint's gathers).
constexpr bool kFwdSpread = true;
constexpr bool kAdjSpread = false;
// A window row is copied and flushed by kStageCols threads (at most that
// many columns).
constexpr int kStageCols = 16;
constexpr int kTableWidth = 12;
// Offsets passed in the kernels' parameters (the rest computed: offset_at).
constexpr int kParamOffsets = 64;
constexpr int kMaxAnglesPerLaunch = 65535;
// The forward's blocks: enough (tile, angle group) pairs to fill the card
// several times over.
constexpr long long kTargetBlocks = 2048;
// 1.5 2^23 and its bit pattern: y + kMagic rounded down is floor(y) +
// kMagic for |y| < 2^22, and its bits are those of kMagic plus floor(y).
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// The first kParamOffsets sub-voxel offsets c_i, passed by value in the
// kernels' parameters.
struct Offsets {
  float c[kParamOffsets];
};

// c_i: from the parameters, or past them (precision > kParamOffsets) the
// float64 quotient rounded to float32, as the host's table.
__device__ __forceinline__ float offset_at(const Offsets& offs, int i, int precision) {
  return i < kParamOffsets ? offs.c[i] : __double2float_rn(__ddiv_rn(i + 0.5, precision));
}

struct Angle {
  float nx, ny, nz, st, cqct, sqct, nsq, cq;
};

__device__ __forceinline__ Angle angle_row(const float* __restrict__ table, int t) {
  const float* r = table + kTableWidth * t;
  return Angle{__ldg(r + 0), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3),
               __ldg(r + 4), __ldg(r + 5), __ldg(r + 6), __ldg(r + 7)};
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// The in-plane coordinates (y, z) of point p for one angle, in the JAX
// package's order of float32 operations, each rounded on its own, from
// s01 = p0 nx + p1 ny and a2 = p2 nz, which the callers hoist.
__device__ __forceinline__ float2 yz(const Angle& a, float p0, float p1, float p2, float s01,
                                     float a2) {
  const float d = __fadd_rn(s01, a2);
  const float px = __fsub_rn(p0, __fmul_rn(d, a.nx));
  const float py = __fsub_rn(p1, __fmul_rn(d, a.ny));
  const float pz = __fsub_rn(p2, __fmul_rn(d, a.nz));
  return make_float2(
      __fadd_rn(__fadd_rn(__fmul_rn(a.st, px), __fmul_rn(a.cqct, py)), __fmul_rn(a.sqct, pz)),
      __fadd_rn(__fmul_rn(a.nsq, py), __fmul_rn(a.cq, pz)));
}

// The plane cell of point p for one angle (the voxel kernels').
__device__ __forceinline__ long long cell(const Angle& a, float p0, float p1, float p2,
                                          int n) {
  const float2 q = yz(a, p0, p1, p2, __fadd_rn(__fmul_rn(p0, a.nx), __fmul_rn(p1, a.ny)),
                      __fmul_rn(p2, a.nz));
  const int half = n / 2;
  const int iy = floor_mod(__float2int_rd(q.x) + half, n);
  const int iz = floor_mod(__float2int_rd(q.y) + half, n);
  return static_cast<long long>(iy) * n + iz;
}

// Calls visit(yz) for each point of the voxel at g for angle a, in the order
// (i, j, k), k fastest. P > 0 is the precision, known when compiled (the
// loops unroll and a voxel's p1, p2 and p2 nz stay in registers); P == 0
// reads it at run time.
template <int P, typename Visit>
__device__ __forceinline__ void for_each_point(const Angle& a, const Offsets& offs, int precision,
                                               const float (&g)[3], Visit&& visit) {
  if constexpr (P > 0) {
    float p1[P], p2[P], a2[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      p1[k] = __fadd_rn(g[1], offs.c[k]);
      p2[k] = __fadd_rn(g[2], offs.c[k]);
      a2[k] = __fmul_rn(p2[k], a.nz);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float p0 = __fadd_rn(g[0], offs.c[i]);
      const float a0 = __fmul_rn(p0, a.nx);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float s01 = __fadd_rn(a0, __fmul_rn(p1[j], a.ny));
#pragma unroll
        for (int k = 0; k < P; ++k) visit(yz(a, p0, p1[j], p2[k], s01, a2[k]));
      }
    }
  } else {
    for (int i = 0; i < precision; ++i) {
      const float p0 = __fadd_rn(g[0], offset_at(offs, i, precision));
      const float a0 = __fmul_rn(p0, a.nx);
      for (int j = 0; j < precision; ++j) {
        const float p1 = __fadd_rn(g[1], offset_at(offs, j, precision));
        const float s01 = __fadd_rn(a0, __fmul_rn(p1, a.ny));
        for (int k = 0; k < precision; ++k) {
          const float p2 = __fadd_rn(g[2], offset_at(offs, k, precision));
          visit(yz(a, p0, p1, p2, s01, __fmul_rn(p2, a.nz)));
        }
      }
    }
  }
}

// This thread's voxel of the block's tile of the x-slab of the n^3 lattice
// (make_grid(n): axis 0 slowest, each axis from -ceil(n/2)) that holds rows
// x0 .. x0 + rows - 1 of axis 0, the whole lattice at x0 = 0, rows = n; the
// warps' voxels spread or in rows (kFwdSpread). blockIdx.y is the tile's
// place on axis 0 from x0, blockIdx.x its place on axes 1 and 2. The flat
// index is the slab's own, and tiles past the slab's last row are cut as
// the lattice's edge tiles are.
struct Tile {
  float corner[3];  // the tile's lowest voxel coordinates
  float g[3];       // this thread's voxel's
  long long index;  // its flat index in the slab
  bool inside;      // whether it lies in the slab (edge tiles are cut)
};

template <bool kSpread>
__device__ __forceinline__ Tile tile_of(int n, int x0, int rows) {
  const int tiles = (n + kTile - 1) / kTile;
  const int a1 = blockIdx.x / tiles;
  const int a2 = blockIdx.x - a1 * tiles;
  const int a0 = blockIdx.y;
  const int lo = (n + 1) / 2;
  int v0, v1, v2;  // v0 from the slab's first row
  if constexpr (kSpread) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    v0 = a0 * kTile + ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((warp >> 3) & 1);
    v1 = a1 * kTile + ((lane >> 2) & 1) * 4 + ((lane >> 1) & 1) * 2 + ((warp >> 2) & 1);
    v2 = a2 * kTile + (lane & 1) * 4 + (warp & 3);
  } else {
    v0 = a0 * kTile + threadIdx.x / (kTile * kTile);
    v1 = a1 * kTile + (threadIdx.x / kTile) % kTile;
    v2 = a2 * kTile + threadIdx.x % kTile;
  }
  Tile t;
  t.corner[0] = static_cast<float>(x0 + a0 * kTile - lo);
  t.corner[1] = static_cast<float>(a1 * kTile - lo);
  t.corner[2] = static_cast<float>(a2 * kTile - lo);
  t.g[0] = static_cast<float>(x0 + v0 - lo);
  t.g[1] = static_cast<float>(v1 - lo);
  t.g[2] = static_cast<float>(v2 - lo);
  t.index = (static_cast<long long>(v0) * n + v1) * n + v2;
  t.inside = v0 < rows && v1 < n && v2 < n;
  return t;
}

// A tile's window of the plane of one angle: its first row y0 and column z0
// (floor of the tile's lowest in-plane coordinates, before the + n/2), its
// rows and columns, and kMagicBits + y0, + z0, which a point's round-down
// bits less give its row and column in the window.
struct Window {
  int y0, z0, rows, cols, cy, cz;
};

// Placed from the tile's corner in rounded float32 operations (mirrored by
// tests/_torch_bucket_cases.py::window_origins); the host's margin in
// columns 8-9 covers their rounding and the points'.
__device__ __forceinline__ Window window_of(const float* __restrict__ table, int t,
                                            const float (&corner)[3]) {
  const float* r = table + kTableWidth * t;
  const float by = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(r + 3), corner[0]),
                                                 __fmul_rn(__ldg(r + 4), corner[1])),
                                       __fmul_rn(__ldg(r + 5), corner[2])),
                             __ldg(r + 8));
  const float bz = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(r + 6), corner[1]),
                                       __fmul_rn(__ldg(r + 7), corner[2])),
                             __ldg(r + 9));
  Window w;
  w.y0 = __float2int_rd(by);
  w.z0 = __float2int_rd(bz);
  w.rows = static_cast<int>(__ldg(r + 10));
  w.cols = static_cast<int>(__ldg(r + 11));
  w.cy = kMagicBits + w.y0;
  w.cz = kMagicBits + w.z0;
  return w;
}

// The point's cell in the window (row * pitch + column), or -1 outside it;
// row and column are the point's own, unwrapped, less the window's.
__device__ __forceinline__ int window_cell(const Window& w, float2 q, int pitch, int& row,
                                           int& col) {
  row = __float_as_int(__fadd_rd(q.x, kMagic)) - w.cy;
  col = __float_as_int(__fadd_rd(q.y, kMagic)) - w.cz;
  if (static_cast<unsigned>(row) < static_cast<unsigned>(w.rows) &&
      static_cast<unsigned>(col) < static_cast<unsigned>(w.cols)) {
    return row * pitch + col;
  }
  return -1;
}

// The plane cell of a window's row and column (which may lie outside it).
__device__ __forceinline__ long long plane_cell(const Window& w, int row, int col, int n) {
  const int half = n / 2;
  return static_cast<long long>(floor_mod(w.y0 + half + row, n)) * n +
         floor_mod(w.z0 + half + col, n);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's copies but the latest kPending groups have landed.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying the window w of plane into buf (pitch values a row), a
// row to kStageCols threads.
__device__ __forceinline__ void stage_window(float2* buf, int pitch,
                                             const float2* __restrict__ plane, const Window& w,
                                             int n) {
  const int col = threadIdx.x % kStageCols;
  if (col >= w.cols) return;
  for (int row = threadIdx.x / kStageCols; row < w.rows; row += kTileThreads / kStageCols) {
    cp_async8(buf + row * pitch + col, plane + plane_cell(w, row, col, n));
  }
}

// Add each nonzero cell of the rows x cols window at w's origin in buf (its
// kWindowCopies copies, window_cells apart, summed in order) to plane, and
// zero it.
__device__ __forceinline__ void flush_window(float2* buf, int pitch, int window_cells,
                                             float2* plane, const Window& w, int rows, int cols,
                                             int n) {
  const int col = threadIdx.x % kStageCols;
  if (col >= cols) return;
  for (int row = threadIdx.x / kStageCols; row < rows; row += kTileThreads / kStageCols) {
    float2* c = buf + row * pitch + col;
    float2 v = *c;
    *c = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 1; k < kWindowCopies; ++k) {
      const float2 more = c[k * window_cells];
      c[k * window_cells] = make_float2(0.0f, 0.0f);
      v.x += more.x;
      v.y += more.y;
    }
    if (v.x != 0.0f || v.y != 0.0f) atomicAdd(plane + plane_cell(w, row, col, n), v);
  }
}

// *cell += v in shared memory (each part a compare-and-swap loop on this
// card, which has no shared float atomic add; one 64-bit loop for both
// parts took 1.5 times as long at full width).
__device__ __forceinline__ void shared_add(float2* cell, float2 v) {
  atomicAdd(&cell->x, v.x);
  atomicAdd(&cell->y, v.y);
}

// The lowest in-plane coordinate a voxel's points reach, relative to the
// voxel, along the unit direction e (y's or z's), less a margin (1/32 cell,
// inside the window's 1/16): sum_i min(e_i c_0, e_i c_last).
__device__ __forceinline__ float box_low(float e0, float e1, float e2, float c0, float cl) {
  return fminf(e0 * c0, e0 * cl) + fminf(e1 * c0, e1 * cl) + fminf(e2 * c0, e2 * cl) - 0.03125f;
}

// A voxel's points of one angle added one at a time: into the window, or
// past it to the plane and the counter. Kept out of line, for the rare
// voxel whose points miss their box.
template <int P>
__device__ __noinline__ void add_points(const Angle& a, const Offsets& offs, int precision,
                                        const float (&g)[3], const Window& w, float2 value,
                                        float2* buf, int pitch, float2* plane, int n,
                                        unsigned long long* outside) {
  for_each_point<P>(a, offs, precision, g, [&](float2 q) {
    int row, col;
    const int c = window_cell(w, q, pitch, row, col);
    if (c >= 0) {
      shared_add(buf + c, value);
    } else {
      atomicAdd(plane + plane_cell(w, row, col, n), value);
      atomicAdd(outside, 1ull);
    }
  });
}

// A voxel's adjoint summed again from the planes in global memory, in the
// same order (angles outer, points inner), each point outside its window
// adding 1 to the counter. Kept out of line, for the rare voxel with such a
// point.
template <int P>
__device__ __noinline__ float2 gather_from_planes(const float2* __restrict__ planes,
                                                  const float* __restrict__ table,
                                                  const Offsets& offs, const Tile& tile,
                                                  int angles, int n, int precision, float weight,
                                                  int pitch, unsigned long long* outside) {
  float2 acc = make_float2(0.0f, 0.0f);
  for (int t = 0; t < angles; ++t) {
    const Window w = window_of(table, t, tile.corner);
    const float2* plane = planes + t * static_cast<long long>(n) * n;
    for_each_point<P>(angle_row(table, t), offs, precision, tile.g, [&](float2 q) {
      int row, col;
      if (window_cell(w, q, pitch, row, col) < 0) atomicAdd(outside, 1ull);
      const float2 v = __ldg(plane + plane_cell(w, row, col, n));
      acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, weight));
      acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, weight));
    });
  }
  return acc;
}

template <int P>
__global__ void __launch_bounds__(kTileThreads, kFwdBlocks)
bucket_fwd_kernel(const float2* __restrict__ u, const float* __restrict__ table,
                  float2* __restrict__ planes, const __grid_constant__ Offsets offs,
                  unsigned long long* __restrict__ outside, int angles, int angles_per_block,
                  int n, int precision, float weight, int pitch, int window_cells, int x0,
                  int rows) {
  extern __shared__ float2 windows[];  // two of kWindowCopies of rows x pitch
  const Tile tile = tile_of<kFwdSpread>(n, x0, rows);
  const long long plane_cells = static_cast<long long>(n) * n;
  float2 value = make_float2(0.0f, 0.0f);
  if (tile.inside) {
    const float2 v = __ldg(u + tile.index);
    value = make_float2(__fmul_rn(v.x, weight), __fmul_rn(v.y, weight));
  }
  // A zero voxel adds nothing (a plane cell stays +0, as in the plain sum).
  const bool adds = tile.inside && (value.x != 0.0f || value.y != 0.0f);
  for (int e = threadIdx.x; e < 2 * kWindowCopies * window_cells; e += kTileThreads) {
    windows[e] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const int t_begin = blockIdx.z * angles_per_block;
  const int t_end = min(angles, t_begin + angles_per_block);
  for (int t = t_begin; t < t_end; ++t) {
    float2* window = windows + ((t - t_begin) & 1) * kWindowCopies * window_cells;
    float2* buf = window + (threadIdx.x / 32) % kWindowCopies * window_cells;
    float2* plane = planes + t * plane_cells;
    const Window w = window_of(table, t, tile.corner);
    if (adds) {
      const Angle a = angle_row(table, t);
      if constexpr (kCountCells && P >= 3 && P <= 5) {
        // The voxel's box: 3 x 3 cells from the floor of its points'
        // lowest y and z (less 1/32), which holds every point (they span
        // at most (1 - 1/P) sqrt(3) < 1.4 along y, less along z), and
        // which the window, 2 rows and columns larger than its points,
        // holds (tests/_torch_bucket_cases.py::points_outside_boxes). If a
        // point missed its box (none do), the counts are dropped and each
        // point adds itself.
        const float c0 = offs.c[0], cl = offs.c[P - 1];
        const int by = __float_as_int(__fadd_rd(
            a.st * tile.g[0] + a.cqct * tile.g[1] + a.sqct * tile.g[2] +
                box_low(a.st, a.cqct, a.sqct, c0, cl),
            kMagic));
        const int bz = __float_as_int(__fadd_rd(
            a.nsq * tile.g[1] + a.cq * tile.g[2] + box_low(0.0f, a.nsq, a.cq, c0, cl), kMagic));
        const int box_row = by - w.cy, box_col = bz - w.cz;
        bool missed = box_row < 0 || box_row + 3 > w.rows + 2 || box_col < 0 ||
                      box_col + 3 > w.cols + 2;
        unsigned long long counts = 0;
        for_each_point<P>(a, offs, precision, tile.g, [&](float2 q) {
          const int dy = __float_as_int(__fadd_rd(q.x, kMagic)) - by;
          const int dz = __float_as_int(__fadd_rd(q.y, kMagic)) - bz;
          missed |= (static_cast<unsigned>(dy) > 2u) | (static_cast<unsigned>(dz) > 2u);
          counts += 1ull << ((kCountBits * (3 * dy + dz)) & 63);
        });
        if (!missed) {
          float2* box = buf + box_row * pitch + box_col;
          constexpr unsigned long long kField = (1ull << kCountBits) - 1;
#pragma unroll
          for (int f = 0; f < 9; ++f) {
            const unsigned count = static_cast<unsigned>((counts >> (kCountBits * f)) & kField);
            if (count != 0) {
              const float k = static_cast<float>(count);
              shared_add(box + (f / 3) * pitch + f % 3,
                         make_float2(__fmul_rn(k, value.x), __fmul_rn(k, value.y)));
            }
          }
        } else {
          add_points<P>(a, offs, precision, tile.g, w, value, buf, pitch, plane, n, outside);
        }
      } else {
        for_each_point<P>(a, offs, precision, tile.g, [&](float2 q) {
          int row, col;
          const int c = window_cell(w, q, pitch, row, col);
          if (c >= 0) {
            shared_add(buf + c, value);
          } else {
            atomicAdd(plane + plane_cell(w, row, col, n), value);
            atomicAdd(outside, 1ull);
          }
        });
      }
    }
    // Every point of angle t is in buf; angle t + 1 goes to the other
    // buffer, which this barrier also shows flushed (angle t - 1's).
    __syncthreads();
    flush_window(window, pitch, window_cells, plane, w, w.rows + 2, w.cols + 2, n);
  }
}

template <int P>
__global__ void __launch_bounds__(kTileThreads, kAdjBlocks)
bucket_adj_kernel(const float2* __restrict__ planes, const float* __restrict__ table,
                  float2* __restrict__ out, const __grid_constant__ Offsets offs,
                  unsigned long long* __restrict__ outside, int angles, int n, int precision,
                  float weight, int pitch, int window_cells, int x0, int rows) {
  extern __shared__ float2 windows[];  // kStages of rows x pitch
  const Tile tile = tile_of<kAdjSpread>(n, x0, rows);
  const long long plane_cells = static_cast<long long>(n) * n;
  float2 acc = make_float2(0.0f, 0.0f);
  bool missed = false;
  // Angles 0 .. kStages - 2 in flight, a copy group each.
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < angles) {
      stage_window(windows + t * window_cells, pitch, planes + t * plane_cells,
                   window_of(table, t, tile.corner), n);
    }
    cp_async_commit();
  }
  for (int t = 0; t < angles; ++t) {
    cp_async_wait<kStages - 2>();  // angle t's group has landed
    // Every thread's part of angle t's window is in, and every thread is
    // done with angle t - 1's buffer, which angle t + kStages - 1 takes.
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < angles) {
      stage_window(windows + (next % kStages) * window_cells, pitch, planes + next * plane_cells,
                   window_of(table, next, tile.corner), n);
    }
    cp_async_commit();
    if (tile.inside) {
      const Window w = window_of(table, t, tile.corner);
      const float2* buf = windows + (t % kStages) * window_cells;
      // Every point from the window, its index kept inside the buffer; if
      // a point missed its window (none do), the voxel is summed again
      // from the planes at the end.
      for_each_point<P>(angle_row(table, t), offs, precision, tile.g, [&](float2 q) {
        const int row = __float_as_int(__fadd_rd(q.x, kMagic)) - w.cy;
        const int col = __float_as_int(__fadd_rd(q.y, kMagic)) - w.cz;
        missed |= (static_cast<unsigned>(row) >= static_cast<unsigned>(w.rows)) |
                  (static_cast<unsigned>(col) >= static_cast<unsigned>(w.cols));
        const float2 v = buf[min(static_cast<unsigned>(row * pitch + col),
                                 static_cast<unsigned>(window_cells - 1))];
        acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, weight));
        acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, weight));
      });
    }
  }
  if (missed) {
    acc = gather_from_planes<P>(planes, table, offs, tile, angles, n, precision, weight, pitch,
                                outside);
  }
  if (tile.inside) out[tile.index] = acc;
}

__global__ void __launch_bounds__(kThreads)
bucket_fwd_voxel_kernel(const float2* __restrict__ u, const int* __restrict__ grid,
                        const float* __restrict__ table, float2* __restrict__ planes,
                        const __grid_constant__ Offsets offs, long long voxels, int n,
                        int precision, float weight) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= voxels) return;
  const int t = blockIdx.y;
  const Angle a = angle_row(table, t);
  const float g0 = static_cast<float>(__ldg(grid + 3 * g + 0));
  const float g1 = static_cast<float>(__ldg(grid + 3 * g + 1));
  const float g2 = static_cast<float>(__ldg(grid + 3 * g + 2));
  const float2 value = __ldg(u + g);
  const float2 w = make_float2(__fmul_rn(value.x, weight), __fmul_rn(value.y, weight));
  float2* plane = planes + static_cast<long long>(t) * n * n;
  for (int i = 0; i < precision; ++i) {
    const float p0 = __fadd_rn(g0, offset_at(offs, i, precision));
    for (int j = 0; j < precision; ++j) {
      const float p1 = __fadd_rn(g1, offset_at(offs, j, precision));
      for (int k = 0; k < precision; ++k) {
        const float p2 = __fadd_rn(g2, offset_at(offs, k, precision));
        atomicAdd(plane + cell(a, p0, p1, p2, n), w);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_adj_voxel_kernel(const float2* __restrict__ planes, const int* __restrict__ grid,
                        const float* __restrict__ table, float2* __restrict__ out,
                        const __grid_constant__ Offsets offs, long long voxels, int angles,
                        int n, int precision, float weight) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= voxels) return;
  const float g0 = static_cast<float>(__ldg(grid + 3 * g + 0));
  const float g1 = static_cast<float>(__ldg(grid + 3 * g + 1));
  const float g2 = static_cast<float>(__ldg(grid + 3 * g + 2));
  float2 acc = make_float2(0.0f, 0.0f);
  for (int t = 0; t < angles; ++t) {
    const Angle a = angle_row(table, t);
    const float2* plane = planes + static_cast<long long>(t) * n * n;
    for (int i = 0; i < precision; ++i) {
      const float p0 = __fadd_rn(g0, offset_at(offs, i, precision));
      for (int j = 0; j < precision; ++j) {
        const float p1 = __fadd_rn(g1, offset_at(offs, j, precision));
        for (int k = 0; k < precision; ++k) {
          const float p2 = __fadd_rn(g2, offset_at(offs, k, precision));
          const float2 v = __ldg(plane + cell(a, p0, p1, p2, n));
          acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, weight));
          acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, weight));
        }
      }
    }
  }
  out[g] = acc;
}

// Shared memory of the forward's and the adjoint's windows: with a row of
// at most kStageCols values and the rows window_limits gives (ops/
// bucket.py), within the 48 KB a kernel takes without asking.
size_t fwd_shared(int window_cells) { return 2 * kWindowCopies * sizeof(float2) * window_cells; }
size_t adj_shared(int window_cells) { return kStages * sizeof(float2) * window_cells; }

bool valid(long long voxels, int angles, int n, int precision, int pitch, int window_cells) {
  return voxels >= 0 && angles >= 0 && n >= 1 && n <= 46340 && precision >= 1 &&
         pitch >= 1 && pitch <= kStageCols && window_cells >= pitch;
}

// The lattice's slab: rows x0 .. x0 + rows - 1 of axis 0, all of whose
// voxels the volume holds.
bool valid_slab(long long voxels, int n, int x0, int rows) {
  return x0 >= 0 && rows >= 0 && x0 + rows <= n &&
         voxels == static_cast<long long>(rows) * n * n;
}

Offsets offsets_of(const void* offsets, int precision) {
  Offsets o{};
  const int given = precision < kParamOffsets ? precision : kParamOffsets;
  for (int i = 0; i < given; ++i) o.c[i] = static_cast<const float*>(offsets)[i];
  return o;
}

unsigned int voxel_blocks(long long voxels) {
  return static_cast<unsigned int>((voxels + kThreads - 1) / kThreads);
}

// Calls launch(std::integral_constant<int, P>) with P the precision where
// its kernels are compiled for it, else 0 (runtime loops).
template <typename Launch>
void by_precision(int precision, Launch&& launch) {
  switch (precision) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    default: launch(std::integral_constant<int, 0>()); break;
  }
}

}  // namespace

// planes (angles x n x n complex64), every value written = the forward
// projection of u (voxels complex64) at the voxels of grid (voxels x 3 int32,
// or NULL for the full n^3 lattice in make_grid's order) for the angles of
// table (angles x 12 float32, see above), each point weighted by weight
// (1 / precision^3 as float32), at the sub-voxel offsets (precision float32
// values in host memory). Without a grid, u holds the x-slab of the lattice
// whose rows of axis 0 are x0 .. x0 + rows - 1 (x0 = 0, rows = n: all of
// it); with a grid, x0 and rows are not read. The lattice's kernels add
// each point outside its window to *outside (one unsigned 64-bit counter on
// the card) and use windows of at most window_cells values, pitch a row.
// Returns a cudaError_t.
extern "C" int tike_bucket_fwd(const void* u, const void* grid, const void* table, void* planes,
                               void* outside, const void* offsets, long long voxels, int angles,
                               int n, int precision, float weight, int pitch, int window_cells,
                               int x0, int rows, void* stream) {
  if (!valid(voxels, angles, n, precision, pitch, window_cells) ||
      (grid == nullptr && !valid_slab(voxels, n, x0, rows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(n) * n;
  if (angles == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(planes, 0, sizeof(float2) * plane * angles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (voxels == 0) return static_cast<int>(cudaGetLastError());
  const Offsets offs = offsets_of(offsets, precision);
  const float2* uu = static_cast<const float2*>(u);
  const float* tt = static_cast<const float*>(table);
  float2* pp = static_cast<float2*>(planes);
  if (grid == nullptr) {
    const long long tiles = (n + kTile - 1) / kTile;
    const long long slab_tiles = (rows + kTile - 1) / kTile;
    const long long tile_count = tiles * tiles * slab_tiles;
    long long groups = (kTargetBlocks + tile_count - 1) / tile_count;
    groups = groups < angles ? groups : angles;
    const int per_block = static_cast<int>((angles + groups - 1) / groups);
    const dim3 blocks(static_cast<unsigned int>(tiles * tiles),
                      static_cast<unsigned int>(slab_tiles),
                      static_cast<unsigned int>((angles + per_block - 1) / per_block));
    const size_t shared = fwd_shared(window_cells);
    auto* counter = static_cast<unsigned long long*>(outside);
    by_precision(precision, [&](auto p) {
      bucket_fwd_kernel<decltype(p)::value><<<blocks, kTileThreads, shared, s>>>(
          uu, tt, pp, offs, counter, angles, per_block, n, precision, weight, pitch, window_cells,
          x0, rows);
      err = cudaGetLastError();
    });
    return static_cast<int>(err);
  }
  const int* gg = static_cast<const int*>(grid);
  for (int t0 = 0; t0 < angles; t0 += kMaxAnglesPerLaunch) {
    const int count = angles - t0 < kMaxAnglesPerLaunch ? angles - t0 : kMaxAnglesPerLaunch;
    const dim3 blocks(voxel_blocks(voxels), static_cast<unsigned int>(count));
    bucket_fwd_voxel_kernel<<<blocks, kThreads, 0, s>>>(
        uu, gg, tt + kTableWidth * t0, pp + plane * t0, offs, voxels, n, precision, weight);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// out (voxels complex64), every value written = the adjoint of
// tike_bucket_fwd applied to planes (angles x n x n complex64), on the same
// grid or slab.
extern "C" int tike_bucket_adj(const void* planes, const void* grid, const void* table,
                               void* out, void* outside, const void* offsets, long long voxels,
                               int angles, int n, int precision, float weight, int pitch,
                               int window_cells, int x0, int rows, void* stream) {
  if (!valid(voxels, angles, n, precision, pitch, window_cells) ||
      (grid == nullptr && !valid_slab(voxels, n, x0, rows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (voxels == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Offsets offs = offsets_of(offsets, precision);
  const float2* pp = static_cast<const float2*>(planes);
  const float* tt = static_cast<const float*>(table);
  float2* oo = static_cast<float2*>(out);
  if (grid == nullptr) {
    const unsigned int tiles = static_cast<unsigned int>((n + kTile - 1) / kTile);
    const dim3 blocks(tiles * tiles, static_cast<unsigned int>((rows + kTile - 1) / kTile));
    const size_t shared = adj_shared(window_cells);
    auto* counter = static_cast<unsigned long long*>(outside);
    by_precision(precision, [&](auto p) {
      bucket_adj_kernel<decltype(p)::value><<<blocks, kTileThreads, shared, s>>>(
          pp, tt, oo, offs, counter, angles, n, precision, weight, pitch, window_cells, x0, rows);
    });
    return static_cast<int>(cudaGetLastError());
  }
  const int* gg = static_cast<const int*>(grid);
  bucket_adj_voxel_kernel<<<voxel_blocks(voxels), kThreads, 0, s>>>(
      pp, gg, tt, oo, offs, voxels, angles, n, precision, weight);
  return static_cast<int>(cudaGetLastError());
}

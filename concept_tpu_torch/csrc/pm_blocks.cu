// CIC deposit and gather on 2³-mesh-cell blocks from block-sorted
// particles: the PM-only path's block kernels.
//
// Replaces concept_tpu/grid/pallas_pm.py
//   _deposit_kernel (:54; deposit_pallas_kc, pallas_call at :139) and
//   _gather_kernel  (:81; gather_pallas_kc, pallas_call at :171).
//
// Inputs (grid/bucketed.sort_blocks): the N particles in block order,
// C = nb³ blocks with x-major ids c = (bx·nb + by)·nb + bz, nb = n/2.
// Per particle: lidx (int32), the CIC anchor in its block's 4³ halo
// mini-grid, (lx·4 + ly)·4 + lz with each of lx, ly, lz in [0, 2] (a
// particle is bucketed by its own cell, so its anchor lies within one
// cell of it; other values are clamped into [0, 2], which keeps every
// access inside the tile); the CIC fractions fx, fy, fz; and q (deposit:
// the weight).  Per block: starts, the exclusive running sum of the
// blocks' full counts (block c holds sorted particles [starts[c],
// starts[c + 1]), N after the last), and counts, which cut the block to
// its first counts[c] particles (the rest are not deposited and gather
// 0).  The global anchor is 2·(bx, by, bz) − 1 + (lx, ly, lz), modulo n.
//
// What bounds them on the card: device memory.  A particle moves 20 bytes
// in (lidx, fx, fy, fz, q) and the mesh is written once (deposit), or 16
// bytes in, 4·D out and D meshes read (gather); ~30 FP32 operations a
// particle and field.
//
// Design.  The TPU kernels run over slot-major (K, C) buckets padded to
// the capacity K, because its lanes wanted dense (K, 128) tiles; here a
// CTA takes a tile of TX × TY × TZ blocks and only the particles the
// tile holds.  Block ids run along z, so the tile's TX·TY runs of TZ
// blocks are TX·TY contiguous ranges of the sorted arrays, read
// coalesced; an exclusive scan of the tile's block lengths in shared
// memory maps a thread's particle index to its block by a binary search.
// The tile's halo, (2·TX + 2)(2·TY + 2)(2·TZ + 2) mesh cells (the
// corners reach one cell beyond the blocks), lives in shared memory:
//   deposit (tiles of 4 × 8 × 8 blocks): the particles add their 8 corner
//     weights (wx·wy·wz)·q, in the TPU kernel's order, to the halo tile
//     with shared atomics; the tile then goes to the zeroed mesh by one
//     global atomic a nonzero cell, in place of 8 a particle;
//   gather (tiles of 4 × 4 × 8 blocks): the CTA stages the halo of all D
//     fields with asynchronous copies along z, the periodic wrap taken
//     there, and every particle reads its 8·D corners from shared memory
//     and writes D values at its sorted index ((D, N), coalesced): one
//     launch for the three gradient components.
// Measured beside the alternatives (PERF.md §6): plain stores for
// the cells no other tile reaches, and a halo copy per warp to spread a
// clump's shared atomics, were slower; so were the other tile shapes
// tried, and staging through registers (the gather waited on its loads).
// The last tiles along a dimension are clipped to the mesh; a mesh
// smaller than a tile (nb < TZ) is one clipped tile along that
// dimension, whose halo wraps onto itself (its halo cells map to global
// cells with the wrap, and atomics add the copies).  Atomics add in no
// fixed order.
//
// Both kernels are templates on the scalar type of the fractions,
// weights and meshes, instantiated for float and double (the _f64 launch
// functions).  The double kernels keep the float tiles: their halos take
// twice the bytes (25 KB for the deposit, 43 KB for the gather at
// D = 3), the mesh takes scalar atomicAdd(double*), native since sm_60,
// and cp.async copies 8 bytes a cell.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

// The dynamic shared memory as the scalar type's halo (one name a type).
__device__ __forceinline__ float* shared_halo(float*) {
  extern __shared__ float halo_f[];
  return halo_f;
}
__device__ __forceinline__ double* shared_halo(double*) {
  extern __shared__ double halo_d[];
  return halo_d;
}

template <int TX, int TY, int TZ>
struct Tile {
  static constexpr int kBlocks = TX * TY * TZ;
  static constexpr int HX = 2 * TX + 2, HY = 2 * TY + 2, HZ = 2 * TZ + 2;
  static constexpr int kCells = HX * HY * HZ;
  static_assert(kBlocks <= kThreads && (kBlocks & (kBlocks - 1)) == 0,
                "a tile's blocks: a power of two, at most one per thread");

  // shared: the exclusive scan of the blocks' lengths (kBlocks + 1
  // entries), each block's first sorted particle and its cut
  int* pre;
  int* first;
  int* cut;
  int bx0, by0, bz0;  // the tile's first block
  int ex, ey, ez;     // its extent inside the mesh, in blocks
  int P;              // its particles

  static int count(int nb) {
    return ((nb + TX - 1) / TX) * ((nb + TY - 1) / TY) * ((nb + TZ - 1) / TZ);
  }

  // Locate blockIdx.x's tile (z fastest) and load its blocks' ranges.
  // All threads call it; it ends with a barrier.
  __device__ void load(const int* __restrict__ starts, const int* __restrict__ counts, int N,
                       int nb, int* pre_s, int* first_s, int* cut_s, int* warp_s) {
    pre = pre_s;
    first = first_s;
    cut = cut_s;
    const int ntz = (nb + TZ - 1) / TZ, nty = (nb + TY - 1) / TY;
    const int t = blockIdx.x;
    bz0 = (t % ntz) * TZ;
    by0 = ((t / ntz) % nty) * TY;
    bx0 = (t / (ntz * nty)) * TX;
    ex = min(TX, nb - bx0);
    ey = min(TY, nb - by0);
    ez = min(TZ, nb - bz0);
    const int b = threadIdx.x;
    int len = 0;
    if (b < kBlocks) {
      const int lx = b / (TY * TZ), ly = (b / TZ) % TY, lz = b % TZ;
      int s = 0, k = 0;
      if (lx < ex && ly < ey && lz < ez) {
        const long long C = (long long)nb * nb * nb;
        const long long c = ((long long)(bx0 + lx) * nb + by0 + ly) * nb + bz0 + lz;
        s = starts[c];
        len = (c + 1 < C ? starts[c + 1] : N) - s;
        k = min(counts[c], len);
      }
      first[b] = s;
      cut[b] = k;
    }
    // block-wide exclusive scan of len: within warps, then over warp sums
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_s[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kThreads / 32 ? warp_s[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kThreads / 32) warp_s[lane] = w;
    }
    __syncthreads();
    if (b < kBlocks) pre[b] = (warp ? warp_s[warp - 1] : 0) + x - len;
    P = warp_s[kThreads / 32 - 1];
    if (b == 0) pre[kBlocks] = P;
    __syncthreads();
  }

  // The tile block of the tile's j-th particle: the largest b with
  // pre[b] ≤ j (empty blocks repeat their neighbour's entry).
  __device__ __forceinline__ int block_of(int j) const {
    int b = 0;
#pragma unroll
    for (int step = kBlocks / 2; step > 0; step >>= 1)
      if (pre[b + step] <= j) b += step;
    return b;
  }

  // The halo-tile index of the particle's anchor: 2·(its block in the
  // tile) + (lx, ly, lz), each in [0, 2·T]; its corners add 0 or 1.
  __device__ __forceinline__ int anchor(int b, int l) const {
    const int hx = 2 * (b / (TY * TZ)) + min(max(l >> 4, 0), 2);
    const int hy = 2 * ((b / TZ) % TY) + min((l >> 2) & 3, 2);
    const int hz = 2 * (b % TZ) + min(l & 3, 2);
    return (hx * HY + hy) * HZ + hz;
  }

  // For halo-tile cell s: whether it lies inside the clipped tile's halo,
  // and its global mesh index (the periodic wrap taken).
  __device__ __forceinline__ bool cell(int s, int n, long long* g) const {
    const int hz = s % HZ, hy = (s / HZ) % HY, hx = s / (HZ * HY);
    if (hx > 2 * ex + 1 || hy > 2 * ey + 1 || hz > 2 * ez + 1) return false;
    *g = ((long long)wrap(2 * bx0 - 1 + hx, n) * n + wrap(2 * by0 - 1 + hy, n)) * n +
         wrap(2 * bz0 - 1 + hz, n);
    return true;
  }
};

template <typename F, int TX, int TY, int TZ>
__global__ void __launch_bounds__(kThreads)
pm_deposit_kernel(const int* __restrict__ lidx, const F* __restrict__ fx,
                  const F* __restrict__ fy, const F* __restrict__ fz,
                  const F* __restrict__ q, const int* __restrict__ starts,
                  const int* __restrict__ counts, int N, int nb, F* __restrict__ grid) {
  using T = Tile<TX, TY, TZ>;
  __shared__ int pre_s[T::kBlocks + 1], first_s[T::kBlocks], cut_s[T::kBlocks];
  __shared__ int warp_s[kThreads / 32];
  F* halo = shared_halo(static_cast<F*>(nullptr));  // kCells
  T tile;
  tile.load(starts, counts, N, nb, pre_s, first_s, cut_s, warp_s);
  if (tile.P == 0) return;
  for (int s = threadIdx.x; s < T::kCells; s += kThreads) halo[s] = F(0);
  __syncthreads();
  for (int j = threadIdx.x; j < tile.P; j += kThreads) {
    const int b = tile.block_of(j);
    const int r = j - tile.pre[b];
    if (r >= tile.cut[b]) continue;
    const int i = tile.first[b] + r;
    const int a = tile.anchor(b, lidx[i]);
    const F f[3] = {fx[i], fy[i], fz[i]};
    const F qv = q[i];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const F wx = cx ? f[0] : F(1) - f[0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const F wy = cy ? f[1] : F(1) - f[1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const F wz = cz ? f[2] : F(1) - f[2];
          atomicAdd(halo + a + (cx * T::HY + cy) * T::HZ + cz, (wx * wy * wz) * qv);
        }
      }
    }
  }
  __syncthreads();
  const int n = 2 * nb;
  for (int s = threadIdx.x; s < T::kCells; s += kThreads) {
    long long g;
    const F v = halo[s];
    if (v != F(0) && tile.cell(s, n, &g)) atomicAdd(grid + g, v);
  }
}

template <typename F, int TX, int TY, int TZ>
__global__ void __launch_bounds__(kThreads)
pm_gather_kernel(const int* __restrict__ lidx, const F* __restrict__ fx,
                 const F* __restrict__ fy, const F* __restrict__ fz,
                 const int* __restrict__ starts, const int* __restrict__ counts, int N, int nb,
                 const F* __restrict__ grids, int D, F* __restrict__ out) {
  using T = Tile<TX, TY, TZ>;
  __shared__ int pre_s[T::kBlocks + 1], first_s[T::kBlocks], cut_s[T::kBlocks];
  __shared__ int warp_s[kThreads / 32];
  F* halo = shared_halo(static_cast<F*>(nullptr));  // D × kCells
  T tile;
  tile.load(starts, counts, N, nb, pre_s, first_s, cut_s, warp_s);
  if (tile.P == 0) return;
  const int n = 2 * nb;
  const long long n3 = (long long)n * n * n;
  // asynchronous copies (cp.async): every load of the halo in flight at
  // once, none through registers
  for (int s = threadIdx.x; s < T::kCells; s += kThreads) {
    long long g;
    if (!tile.cell(s, n, &g)) continue;
    for (int d = 0; d < D; ++d)
      __pipeline_memcpy_async(halo + d * T::kCells + s, grids + d * n3 + g, sizeof(F));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int j = threadIdx.x; j < tile.P; j += kThreads) {
    const int b = tile.block_of(j);
    const int r = j - tile.pre[b];
    const int i = tile.first[b] + r;
    if (r >= tile.cut[b]) {
      for (int d = 0; d < D; ++d) out[d * (long long)N + i] = F(0);
      continue;
    }
    const int a = tile.anchor(b, lidx[i]);
    const F f[3] = {fx[i], fy[i], fz[i]};
    // the 8 corners' halo offsets and weights, shared by the D fields
    int off[8];
    F wt[8];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const F wx = cx ? f[0] : F(1) - f[0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const F wy = cy ? f[1] : F(1) - f[1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const F wz = cz ? f[2] : F(1) - f[2];
          const int k = (cx * 2 + cy) * 2 + cz;
          off[k] = a + (cx * T::HY + cy) * T::HZ + cz;
          wt[k] = wx * wy * wz;
        }
      }
    }
    for (int d = 0; d < D; ++d) {
      const F* S = halo + d * T::kCells;
      F v = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += wt[k] * S[off[k]];
      out[d * (long long)N + i] = v;
    }
  }
}

// Allow the kernel `bytes` of dynamic shared memory: past 48 KB, static
// and dynamic together, only after an opt-in (raised once per kernel).
template <typename Kernel>
static int shared_bytes(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) allowed = bytes;
  return err;
}

template <typename F, int TX, int TY, int TZ>
static int deposit_launch(const int* lidx, const F* fx, const F* fy, const F* fz, const F* q,
                          const int* starts, const int* counts, int N, int nb, F* grid,
                          cudaStream_t stream) {
  using T = Tile<TX, TY, TZ>;
  const size_t bytes = sizeof(F) * T::kCells;
  auto kernel = pm_deposit_kernel<F, TX, TY, TZ>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  kernel<<<T::count(nb), kThreads, bytes, stream>>>(lidx, fx, fy, fz, q, starts, counts, N, nb,
                                                     grid);
  return (int)cudaGetLastError();
}

template <typename F, int TX, int TY, int TZ>
static int gather_launch(const int* lidx, const F* fx, const F* fy, const F* fz,
                         const int* starts, const int* counts, int N, int nb, const F* grids,
                         int D, F* out, cudaStream_t stream) {
  using T = Tile<TX, TY, TZ>;
  const size_t bytes = sizeof(F) * D * T::kCells;
  auto kernel = pm_gather_kernel<F, TX, TY, TZ>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  kernel<<<T::count(nb), kThreads, bytes, stream>>>(lidx, fx, fy, fz, starts, counts, N, nb,
                                                     grids, D, out);
  return (int)cudaGetLastError();
}

// lidx (int32), fx, fy, fz, q: (N,) contiguous, block-sorted; starts,
// counts: (C,) int32, C = nb³; grid (n, n, n) contiguous, n = 2·nb,
// zeroed by the caller.  Returns the cudaError_t of the launch.
extern "C" int pm_deposit_launch(const int* lidx, const float* fx, const float* fy,
                                 const float* fz, const float* q, const int* starts,
                                 const int* counts, int N, int nb, float* grid, void* stream) {
  return deposit_launch<float, 4, 8, 8>(lidx, fx, fy, fz, q, starts, counts, N, nb, grid,
                                        (cudaStream_t)stream);
}

// the same particle and block arrays; grids (D, n, n, n) contiguous; out
// (D, N) contiguous, every entry written.
extern "C" int pm_gather_launch(const int* lidx, const float* fx, const float* fy,
                                const float* fz, const int* starts, const int* counts, int N,
                                int nb, const float* grids, int D, float* out, void* stream) {
  return gather_launch<float, 4, 4, 8>(lidx, fx, fy, fz, starts, counts, N, nb, grids, D, out,
                                       (cudaStream_t)stream);
}

// The same two in double: fractions, weights and meshes float64.
extern "C" int pm_deposit_launch_f64(const int* lidx, const double* fx, const double* fy,
                                     const double* fz, const double* q, const int* starts,
                                     const int* counts, int N, int nb, double* grid,
                                     void* stream) {
  return deposit_launch<double, 4, 8, 8>(lidx, fx, fy, fz, q, starts, counts, N, nb, grid,
                                         (cudaStream_t)stream);
}

extern "C" int pm_gather_launch_f64(const int* lidx, const double* fx, const double* fy,
                                    const double* fz, const int* starts, const int* counts,
                                    int N, int nb, const double* grids, int D, double* out,
                                    void* stream) {
  return gather_launch<double, 4, 4, 8>(lidx, fx, fy, fz, starts, counts, N, nb, grids, D,
                                        out, (cudaStream_t)stream);
}

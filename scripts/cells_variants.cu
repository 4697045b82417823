// Variants of the slot-layout CIC kernels (PERF.md rows 3, 4, 8 and 9) for
// scripts/cells_variants.py: the kernels as built, the first design (one
// thread per slot, 8 global atomics a particle; the gather reading its
// corners from the mesh) as "before", other tile shapes, chunk depths and
// designs, and splits that leave one part of the work out (wrong results,
// for timing only).  The package does not use this file.
#include "../concept_tpu_torch/csrc/cells.cu"

// The first design's gather (the cells' row 4, and the blocks' row 9
// before their tiles): one thread per slot i = k·C + c, neighbouring
// threads on neighbouring columns, each live slot reading its 8·D corners
// from the mesh.  MODE: 0 complete; 1 read w and write it (no position,
// no mesh read); 2 w and the geometry (the live slots' positions), no
// mesh read.
template <int MODE>
__global__ void gather_cells_kernel(const float* __restrict__ px, const float* __restrict__ py,
                                    const float* __restrict__ pz, const float* __restrict__ w,
                                    long long KC, int nc, int cb, bool zmajor, float inv_h,
                                    const float* __restrict__ grids, int D,
                                    float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const int C = nc * nc * nc;
  float q = w[i];
  Geometry<float> g = {};
  if (q != 0.0f && MODE != 1) {
    g = cell_geometry(px[i], py[i], pz[i], (int)(i % C), nc, cb, zmajor, inv_h);
    if (!g.in_halo) q = 0.0f;
  }
  const int n = nc * cb;
  const long long n3 = (long long)n * n * n;
  for (int dd = 0; dd < D; ++dd) {
    float v = MODE == 1 ? q : (MODE == 2 ? q * g.fx : 0.0f);
    if (MODE == 0 && q != 0.0f) {
      const float* G = grids + dd * n3;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float wx = a ? g.fx : 1.0f - g.fx;
        const long long ox = (long long)wrap(g.ix + a, n) * n;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float wy = b ? g.fy : 1.0f - g.fy;
          const long long oy = (ox + wrap(g.iy + b, n)) * n;
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const float wz = d ? g.fz : 1.0f - g.fz;
            v += ((wx * wy * wz) * q) * G[oy + wrap(g.iz + d, n)];
          }
        }
      }
    }
    out[dd * KC + i] = v;
  }
}

// Candidate (b): column slabs of ROWS rows × 32 columns read and written
// as gather_columns_kernel does, each warp walking its columns one at a
// time, lanes down the rows, every slot of the column at once; a warp
// whose column holds at least STAGE_MIN live slots in the chunk (and at
// least one) stages the column's (cb + 2)³ halo of each field in shared
// memory by cp.async, and its lanes read their corners there; the other
// columns read the mesh.

template <int CB, int ROWS, int STAGE_MIN>
__global__ void __launch_bounds__(kThreads)
gather_columns_staged(const float* __restrict__ px, const float* __restrict__ py,
                      const float* __restrict__ pz, const float* __restrict__ w, int K, int nc,
                      float inv_h, const int* __restrict__ ext,
                      const float* __restrict__ grids, int D, float* __restrict__ out) {
  constexpr int P = kGroup + 1, S = ROWS * P, H = CB + 2, H3 = H * H * H;
  constexpr int NS = ROWS / 32;  // a lane's slots in a column
  extern __shared__ float smem[];
  float* sw = smem;  // 4 × S, then a halo of H3 a warp
  const int C = nc * nc * nc;
  const int chunks = (K + ROWS - 1) / ROWS;
  const int r0 = (blockIdx.x % chunks) * ROWS;
  const int c0 = (blockIdx.x / chunks) * kGroup;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* halo = smem + 4 * S + warp * H3;
  const int c = c0 + lane;
  const int kend = c < C ? (ext ? min(K, ext[c]) : K) : 0;
  bool live = false;
  for (int j = warp; j < ROWS; j += kWarps) {
    const int r = r0 + j;
    const long long i = (long long)r * C + c;
    const float q = r < kend ? w[i] : 0.0f;
    sw[j * P + lane] = q;
    if (q != 0.0f) {
      sw[S + j * P + lane] = px[i];
      sw[2 * S + j * P + lane] = py[i];
      sw[3 * S + j * P + lane] = pz[i];
      live = true;
    }
  }
  if (__syncthreads_or(live)) {
    const int n = nc * CB;
    const long long n3 = (long long)n * n * n;
    for (int col = warp; col < kGroup; col += kWarps) {
      const int cc = c0 + col;
      const int cz = cc % nc, cy = (cc / nc) % nc, cx = cc / (nc * nc);
      Geometry<float> g[NS];
      float q[NS];
      int a[NS];  // the anchor's index in the column's halo, −1 if none
      int nlive = 0;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (s * 32 + lane) * P + col;
        q[s] = sw[k];
        a[s] = -1;
        if (q[s] != 0.0f) {
          g[s] = cell_geometry(sw[S + k], sw[2 * S + k], sw[3 * S + k], cc, nc, CB, false,
                               inv_h);
          if (g[s].in_halo) {
            const int lx = (g[s].ix - cx * CB + 1 + n) % n;
            const int ly = (g[s].iy - cy * CB + 1 + n) % n;
            const int lz = (g[s].iz - cz * CB + 1 + n) % n;
            a[s] = (lx * H + ly) * H + lz;
          } else {
            sw[k] = 0.0f;
          }
        }
        nlive += __popc(__ballot_sync(~0u, a[s] >= 0));
      }
      if (nlive == 0) continue;
      const bool stage = nlive >= STAGE_MIN;
      for (int d = 0; d < D; ++d) {
        const float* G = grids + d * n3;
        if (stage) {
          __syncwarp();
          for (int i = lane; i < H3; i += 32) {
            const int hz = i % H, hy = (i / H) % H, hx = i / (H * H);
            __pipeline_memcpy_async(
                halo + i,
                G + ((long long)wrap(cx * CB - 1 + hx, n) * n + wrap(cy * CB - 1 + hy, n)) * n +
                    wrap(cz * CB - 1 + hz, n),
                4);
          }
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncwarp();
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          if (a[s] < 0) continue;
          float v = 0.0f;
#pragma unroll
          for (int ca = 0; ca < 2; ++ca) {
            const float wx = ca ? g[s].fx : 1.0f - g[s].fx;
            const long long ox = (long long)wrap(g[s].ix + ca, n) * n;
#pragma unroll
            for (int cq = 0; cq < 2; ++cq) {
              const float wy = cq ? g[s].fy : 1.0f - g[s].fy;
              const long long oy = (ox + wrap(g[s].iy + cq, n)) * n;
#pragma unroll
              for (int ce = 0; ce < 2; ++ce) {
                const float wz = ce ? g[s].fz : 1.0f - g[s].fz;
                const float m = stage ? halo[a[s] + (ca * H + cq) * H + ce]
                                      : G[oy + wrap(g[s].iz + ce, n)];
                v += ((wx * wy * wz) * q[s]) * m;
              }
            }
          }
          sw[(1 + d) * S + (s * 32 + lane) * P + col] = v;
        }
      }
    }
  }
  __syncthreads();
  if (c >= C) return;
  const long long KC = (long long)K * C;
  const int rows = min(ROWS, K - r0);
  for (int d = 0; d < D; ++d)
    for (int j = warp; j < rows; j += kWarps)
      out[d * KC + (long long)(r0 + j) * C + c] =
          sw[j * P + lane] != 0.0f ? sw[(1 + d) * S + j * P + lane] : 0.0f;
}

// The first design's deposit: one thread per slot, the 8 corner
// weights added straight to the mesh.  GEOMETRY_ONLY: no atomics (the
// sum of the anchors goes to one cell when it is impossible, so the
// compiler keeps the work).  W_ONLY: read w and stop.
template <bool W_ONLY, bool GEOMETRY_ONLY>
__global__ void deposit_slots_kernel(const float* __restrict__ px, const float* __restrict__ py,
                                     const float* __restrict__ pz, const float* __restrict__ w,
                                     long long KC, int nc, int cb, bool zmajor, float inv_h,
                                     float* __restrict__ grid) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const float q = w[i];
  if (q == 0.0f || W_ONLY) return;
  const int C = nc * nc * nc;
  const Geometry<float> g = cell_geometry(px[i], py[i], pz[i], (int)(i % C), nc, cb, zmajor, inv_h);
  if (!g.in_halo) return;
  const int n = nc * cb;
  if (GEOMETRY_ONLY) {
    if (g.ix + g.iy + g.iz == -1000000) grid[0] = g.fx + g.fy + g.fz;
    return;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float wx = a ? g.fx : 1.0f - g.fx;
    const long long ox = (long long)wrap(g.ix + a, n) * n;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wy = b ? g.fy : 1.0f - g.fy;
      const long long oy = (ox + wrap(g.iy + b, n)) * n;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float wz = d ? g.fz : 1.0f - g.fz;
        atomicAdd(grid + oy + wrap(g.iz + d, n), (wx * wy * wz) * q);
      }
    }
  }
}

// MODE: 0 complete; 1 read w only; 2 w and the geometry, no shared or
// global adds; 3 no mesh flush; 4 shared adds without atomics (racy).
template <int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS, int MODE>
__global__ void __launch_bounds__(kThreads)
deposit_variant(const float* __restrict__ px, const float* __restrict__ py,
                const float* __restrict__ pz, const float* __restrict__ w, int K, int nc,
                float inv_h, const int* __restrict__ ext, bool vec, float* __restrict__ grid) {
  using T = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  extern __shared__ float halo[];
  const T tile(nc);
  float q[SLOTS];
  tile.template weights<SLOTS>(w, K, ext, q);
  bool live = false;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) live |= q[s] != 0.0f;
  if (!__syncthreads_or(live) || MODE == 1) return;
  if (MODE != 2)
    for (int s = threadIdx.x; s < T::kCells; s += kThreads) halo[s] = 0.0f;
  __syncthreads();
  const long long C = (long long)nc * nc * nc;
  const int r0 = blockIdx.y * (SLOTS * T::kRowStep) + tile.row;
  int asum = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (q[s] == 0.0f) continue;
    const long long i = (r0 + s * T::kRowStep) * C + tile.c;
    float f[3];
    const int a = tile.anchor(px[i], py[i], pz[i], inv_h, f);
    if (a < 0) continue;
    if (MODE == 2) {
      asum += a + (int)(f[0] + f[1] + f[2]);
      continue;
    }
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float wx = cx ? f[0] : 1.0f - f[0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const float wy = cy ? f[1] : 1.0f - f[1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const float wz = cz ? f[2] : 1.0f - f[2];
          float* h = halo + a + T::corner(cx, cy, cz);
          if (MODE == 4)
            *h += (wx * wy * wz) * q[s];
          else
            atomicAdd(h, (wx * wy * wz) * q[s]);
        }
      }
    }
  }
  if (MODE == 2) {
    if (asum == -1000000) grid[0] = 1.0f;
    return;
  }
  __syncthreads();
  if (MODE == 3) return;
  tile.for_halo(
      vec,
      [&](int s, long long g) {
        if (halo[s] != 0.0f) atomicAdd(grid + g, halo[s]);
      },
      [&](int s, long long g) {
        const float4 v = *reinterpret_cast<const float4*>(halo + s);
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
          atomicAdd(reinterpret_cast<float4*>(grid + g), v);
      });
}

// MODE: 0 complete; 1 no staging (the corners read whatever shared memory
// holds); 2 staging only (then zeros out); 3 read w only (zeros out).
// STAGE: 1 cp.async, 0 through registers.
template <int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS, int MODE,
          int STAGE>
__global__ void __launch_bounds__(kThreads)
gather_variant(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ pz, const float* __restrict__ w, int K, int nc,
               float inv_h, const int* __restrict__ ext, bool vec,
               const float* __restrict__ grids, int D, float* __restrict__ out) {
  using T = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  extern __shared__ float halo[];
  const T tile(nc);
  float q[SLOTS];
  const int kout = tile.template weights<SLOTS>(w, K, ext, q);
  bool live = false;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) live |= q[s] != 0.0f;
  const long long C = (long long)nc * nc * nc, KC = K * C;
  const int r0 = blockIdx.y * (SLOTS * T::kRowStep) + tile.row;
  if (!__syncthreads_or(live) || MODE == 3) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int r = r0 + s * T::kRowStep;
      if (r >= kout) continue;
      for (int d = 0; d < D; ++d) out[d * KC + r * C + tile.c] = 0.0f;
    }
    return;
  }
  const int n = nc * CB;
  const long long n3 = (long long)n * n * n;
  if (MODE != 1)
    tile.for_halo(
        vec,
        [&](int s, long long g) {
          for (int d = 0; d < D; ++d) {
            if (STAGE)
              __pipeline_memcpy_async(halo + d * T::kCells + s, grids + d * n3 + g, 4);
            else
              halo[d * T::kCells + s] = grids[d * n3 + g];
          }
        },
        [&](int s, long long g) {
          for (int d = 0; d < D; ++d) {
            if (STAGE)
              __pipeline_memcpy_async(halo + d * T::kCells + s, grids + d * n3 + g, 16);
            else
              *reinterpret_cast<float4*>(halo + d * T::kCells + s) =
                  *reinterpret_cast<const float4*>(grids + d * n3 + g);
          }
        });
  if (STAGE) __pipeline_commit();
  int a[SLOTS];
  float f[SLOTS][3];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    a[s] = -1;
    if (q[s] == 0.0f || MODE == 2) continue;
    const long long i = (r0 + s * T::kRowStep) * C + tile.c;
    a[s] = tile.anchor(px[i], py[i], pz[i], inv_h, f[s]);
  }
  if (STAGE) __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int r = r0 + s * T::kRowStep;
    if (r >= kout) continue;
    const long long i = r * C + tile.c;
    if (a[s] < 0) {
      for (int d = 0; d < D; ++d) out[d * KC + i] = 0.0f;
      continue;
    }
    int off[8];
    float wt[8];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float wx = cx ? f[s][0] : 1.0f - f[s][0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const float wy = cy ? f[s][1] : 1.0f - f[s][1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const float wz = cz ? f[s][2] : 1.0f - f[s][2];
          const int k = (cx * 2 + cy) * 2 + cz;
          off[k] = a[s] + T::corner(cx, cy, cz);
          wt[k] = (wx * wy * wz) * q[s];
        }
      }
    }
    for (int d = 0; d < D; ++d) {
      const float* S = halo + d * T::kCells;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += wt[k] * S[off[k]];
      out[d * KC + i] = v;
    }
  }
}

typedef int (*DepositFn)(const float*, const float*, const float*, const float*, int, int,
                         float, const int*, float*, cudaStream_t);
typedef int (*GatherFn)(const float*, const float*, const float*, const float*, int, int,
                        float, const int*, const float*, int, float*, cudaStream_t);

template <int CB, bool ZMAJOR>
static int deposit_built(const float* px, const float* py, const float* pz, const float* w,
                         int K, int nc, float inv_h, const int* ext, float* grid,
                         cudaStream_t stream) {
  return cic_deposit_launch(px, py, pz, w, K, nc, CB, ZMAJOR, inv_h, ext, grid, stream);
}

template <int CB, bool ZMAJOR, bool W_ONLY, bool GEOMETRY_ONLY>
static int deposit_before(const float* px, const float* py, const float* pz, const float* w,
                          int K, int nc, float inv_h, const int*, float* grid,
                          cudaStream_t stream) {
  const long long KC = (long long)K * nc * nc * nc;
  const long long blocks = (KC + kThreads - 1) / kThreads;
  deposit_slots_kernel<W_ONLY, GEOMETRY_ONLY><<<(unsigned)blocks, kThreads, 0, stream>>>(
      px, py, pz, w, KC, nc, CB, ZMAJOR, inv_h, grid);
  return (int)cudaGetLastError();
}

template <int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS, int MODE = 0>
static int deposit_tiled(const float* px, const float* py, const float* pz, const float* w,
                         int K, int nc, float inv_h, const int* ext, float* grid,
                         cudaStream_t stream) {
  using T = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  const size_t bytes = sizeof(float) * T::kCells;
  auto kernel = deposit_variant<CB, ZMAJOR, QUADS, TS, TM, TF, SLOTS, MODE>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  const int rows = SLOTS * T::kRowStep;
  const dim3 dims(T::count(nc), (K + rows - 1) / rows);
  kernel<<<dims, kThreads, bytes, stream>>>(px, py, pz, w, K, nc, inv_h, ext,
                                            nc * CB % 4 == 0, grid);
  return (int)cudaGetLastError();
}

template <int CB, bool ZMAJOR>
static int gather_built(const float* px, const float* py, const float* pz, const float* w,
                        int K, int nc, float inv_h, const int* ext, const float* grids, int D,
                        float* out, cudaStream_t stream) {
  return cic_gather_launch(px, py, pz, w, K, nc, CB, ZMAJOR, inv_h, ext, grids, D, out, stream);
}

template <int CB, bool ZMAJOR, int MODE = 0>
static int gather_before(const float* px, const float* py, const float* pz, const float* w,
                         int K, int nc, float inv_h, const int*, const float* grids, int D,
                         float* out, cudaStream_t stream) {
  const long long KC = (long long)K * nc * nc * nc;
  if (KC == 0) return 0;
  const long long blocks = (KC + kThreads - 1) / kThreads;
  gather_cells_kernel<MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      px, py, pz, w, KC, nc, CB, ZMAJOR, inv_h, grids, D, out);
  return (int)cudaGetLastError();
}

template <int CB, int ROWS>
static int gather_slabs(const float* px, const float* py, const float* pz, const float* w,
                        int K, int nc, float inv_h, const int* ext, const float* grids, int D,
                        float* out, cudaStream_t stream) {
  return gather_columns<float, CB, ROWS>(px, py, pz, w, K, nc, inv_h, ext, grids, D, out,
                                         stream);
}

template <int CB, int ROWS, int STAGE_MIN>
static int gather_staged(const float* px, const float* py, const float* pz, const float* w,
                         int K, int nc, float inv_h, const int* ext, const float* grids, int D,
                         float* out, cudaStream_t stream) {
  if (K <= 0 || nc <= 0) return 0;
  constexpr int H = CB + 2;
  const size_t bytes = sizeof(float) * (4 * ROWS * (kGroup + 1) + kWarps * H * H * H);
  auto kernel = gather_columns_staged<CB, ROWS, STAGE_MIN>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  const long long C = (long long)nc * nc * nc, n = (long long)nc * CB;
  const long long blocks = (C + kGroup - 1) / kGroup * ((K + ROWS - 1) / ROWS);
  for (int d0 = 0; d0 < D; d0 += 3) {
    kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
        px, py, pz, w, K, nc, inv_h, ext, grids + d0 * n * n * n, min(3, D - d0),
        out + d0 * K * C);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return 0;
}

template <int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS, int MODE = 0,
          int STAGE = 1>
static int gather_tiled(const float* px, const float* py, const float* pz, const float* w,
                        int K, int nc, float inv_h, const int* ext, const float* grids, int D,
                        float* out, cudaStream_t stream) {
  using T = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  const size_t bytes = sizeof(float) * D * T::kCells;
  auto kernel = gather_variant<CB, ZMAJOR, QUADS, TS, TM, TF, SLOTS, MODE, STAGE>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  const int rows = SLOTS * T::kRowStep;
  const dim3 dims(T::count(nc), (K + rows - 1) / rows);
  kernel<<<dims, kThreads, bytes, stream>>>(px, py, pz, w, K, nc, inv_h, ext,
                                            nc * CB % 4 == 0, grids, D, out);
  return (int)cudaGetLastError();
}

// Each entry serves one layout (cb, zmajor).  Names starting with "split"
// leave work out and give wrong results; "before" is the first design.
struct DepositVariant {
  DepositFn fn;
  const char* name;
  int cb, zmajor;
};
struct GatherVariant {
  GatherFn fn;
  const char* name;
  int cb, zmajor;
  int ext;  // 1: run with the per-column extents
};

// the splits of a tile's deposit: TILE = (CB, ZMAJOR, QUADS, TS, TM, TF)
#define UNPAREN(...) __VA_ARGS__
#define DEP_SPLITS(CB, Z, TILE)                                                            \
  {deposit_before<CB, Z, false, false>, "before (a thread per slot)", CB, Z},              \
  {deposit_tiled<UNPAREN TILE, 4>, "4 slots a thread", CB, Z},                                     \
  {deposit_tiled<UNPAREN TILE, 16>, "16 slots a thread", CB, Z},                                   \
  {deposit_before<CB, Z, true, false>, "split, before: read w only", CB, Z},               \
  {deposit_before<CB, Z, false, true>, "split, before: w and geometry", CB, Z},            \
  {deposit_tiled<UNPAREN TILE, 8, 1>, "split: read w only", CB, Z},                                \
  {deposit_tiled<UNPAREN TILE, 8, 2>, "split: w and geometry", CB, Z},                             \
  {deposit_tiled<UNPAREN TILE, 8, 3>, "split: no mesh flush", CB, Z},                              \
  {deposit_tiled<UNPAREN TILE, 8, 4>, "split: racy shared adds", CB, Z}

static const DepositVariant kDeposit[] = {
    {deposit_built<8, false>, "as built (1x1x8 columns, quads)", 8, false},
    DEP_SPLITS(8, false, (8, false, true, 1, 1, 8)),
    {deposit_tiled<8, false, false, 1, 1, 8, 8>, "1x1x8 columns, cell by cell", 8, false},
    {deposit_tiled<8, false, true, 1, 1, 4, 8>, "1x1x4 columns, quads", 8, false},
    {deposit_tiled<8, false, true, 1, 2, 4, 8>, "1x2x4 columns, quads", 8, false},
    {deposit_tiled<8, false, true, 1, 1, 16, 8>, "1x1x16 columns, quads", 8, false},
    {deposit_built<4, false>, "as built (2x2x8 columns, quads)", 4, false},
    DEP_SPLITS(4, false, (4, false, true, 2, 2, 8)),
    {deposit_tiled<4, false, false, 2, 2, 8, 8>, "2x2x8 columns, cell by cell", 4, false},
    {deposit_tiled<4, false, true, 2, 4, 8, 8>, "2x4x8 columns, quads", 4, false},
    {deposit_tiled<4, false, true, 2, 2, 16, 8>, "2x2x16 columns, quads", 4, false},
    {deposit_built<2, true>, "as built (z8 y4 x8 blocks, cell by cell)", 2, true},
    DEP_SPLITS(2, true, (2, true, false, 8, 4, 8)),
    {deposit_tiled<2, true, true, 8, 4, 8, 8>, "z8 y4 x8 blocks, quads", 2, true},
    {deposit_tiled<2, true, false, 16, 4, 4, 8>, "z16 y4 x4 blocks", 2, true},
    {deposit_tiled<2, true, false, 4, 4, 16, 8>, "z4 y4 x16 blocks", 2, true},
    {deposit_tiled<2, true, false, 32, 4, 2, 8>, "z32 y4 x2 blocks", 2, true},
    {deposit_tiled<2, true, false, 16, 8, 2, 8>, "z16 y8 x2 blocks", 2, true},
};

// the cells' gather (row 4): the first design and its splits, the column
// slabs of each depth, the slabs walked column by column with staged
// halos (STAGE_MIN live slots a column and more), the tiled gather
#define GATHER_CELLS(CB, TILE)                                                             \
  {gather_built<CB, false>, "as built (column slabs, 16 rows)", CB, false, 0},             \
  {gather_before<CB, false>, "before (a thread per slot)", CB, false, 0},                  \
  {gather_before<CB, false, 1>, "split, before: read w only", CB, false, 0},               \
  {gather_before<CB, false, 2>, "split, before: w and geometry", CB, false, 0},            \
  {gather_slabs<CB, 8>, "column slabs, 8 rows", CB, false, 0},                             \
  {gather_slabs<CB, 32>, "column slabs, 32 rows", CB, false, 0},                           \
  {gather_staged<CB, 64, 0>, "64-row slabs by column, halo staged always", CB, false, 0},  \
  {gather_staged<CB, 64, 40>, "64-row slabs by column, staged at 40 live", CB, false, 0},   \
  {gather_staged<CB, 64, 1 << 30>, "64-row slabs by column, never staged", CB, false, 0},   \
  {gather_tiled<UNPAREN TILE, 8>, "tiled gather", CB, false, 0},                           \
  {gather_tiled<UNPAREN TILE, 8>, "tiled gather, with extents", CB, false, 1}

static const GatherVariant kGather[] = {
    GATHER_CELLS(8, (8, false, true, 1, 1, 8)),
    {gather_tiled<8, false, true, 1, 1, 4, 8>, "tiled gather, 1x1x4 columns", 8, false, 0},
    GATHER_CELLS(4, (4, false, true, 2, 2, 8)),
    {gather_built<2, true>, "as built (z8 y4 x8 blocks, cell by cell)", 2, true, 0},
    {gather_before<2, true>, "before (a thread per slot)", 2, true, 0},
    {gather_tiled<2, true, false, 8, 4, 8, 4>, "4 slots a thread", 2, true, 0},
    {gather_tiled<2, true, false, 8, 4, 8, 16>, "16 slots a thread", 2, true, 0},
    {gather_tiled<2, true, false, 8, 4, 8, 8, 0, 0>, "staging through registers", 2, true, 0},
    {gather_tiled<2, true, true, 8, 4, 8, 8>, "z8 y4 x8 blocks, quads", 2, true, 0},
    {gather_tiled<2, true, false, 4, 4, 16, 8>, "z4 y4 x16 blocks", 2, true, 0},
    {gather_tiled<2, true, false, 16, 4, 4, 8>, "z16 y4 x4 blocks", 2, true, 0},
    {gather_tiled<2, true, false, 4, 8, 8, 8>, "z4 y8 x8 blocks", 2, true, 0},
    {gather_tiled<2, true, false, 8, 4, 8, 8, 1>, "split: no staging", 2, true, 0},
    {gather_tiled<2, true, false, 8, 4, 8, 8, 2>, "split: staging only", 2, true, 0},
    {gather_tiled<2, true, false, 8, 4, 8, 8, 3>, "split: read w only, zeros out", 2, true, 0},
};

extern "C" int deposit_variants() { return sizeof(kDeposit) / sizeof(kDeposit[0]); }
extern "C" int gather_variants() { return sizeof(kGather) / sizeof(kGather[0]); }
extern "C" const char* deposit_variant_name(int v) { return kDeposit[v].name; }
extern "C" const char* gather_variant_name(int v) { return kGather[v].name; }
extern "C" int deposit_variant_layout(int v) { return kDeposit[v].cb * 2 + kDeposit[v].zmajor; }
extern "C" int gather_variant_layout(int v) { return kGather[v].cb * 2 + kGather[v].zmajor; }
extern "C" int gather_variant_ext(int v) { return kGather[v].ext; }

// The arguments of cic_deposit_launch / cic_gather_launch after the
// variant, without the layout (the variant's own).
extern "C" int deposit_variant_run(int v, const float* px, const float* py, const float* pz,
                                   const float* w, int K, int nc, float inv_h, const int* ext,
                                   float* grid, void* stream) {
  return kDeposit[v].fn(px, py, pz, w, K, nc, inv_h, ext, grid, (cudaStream_t)stream);
}

extern "C" int gather_variant_run(int v, const float* px, const float* py, const float* pz,
                                  const float* w, int K, int nc, float inv_h, const int* ext,
                                  const float* grids, int D, float* out, void* stream) {
  return kGather[v].fn(px, py, pz, w, K, nc, inv_h, ext, grids, D, out, (cudaStream_t)stream);
}

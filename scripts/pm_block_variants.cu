// Variants of the PM-only block kernels (PERF.md rows 10 and 11) for
// scripts/pm_block_variants.py: the kernels as built, other tile shapes,
// the alternatives their design was chosen over, and splits that leave
// one part of the work out (wrong results, for timing only).  The package
// does not use this file.
#include "../concept_tpu_torch/csrc/pm_blocks.cu"

template <class T>
__device__ __forceinline__ bool interior(const T& t, int s) {
  const int hz = s % T::HZ, hy = (s / T::HZ) % T::HY, hx = s / (T::HZ * T::HY);
  return hx >= 2 && hx < 2 * t.ex && hy >= 2 && hy < 2 * t.ey && hz >= 2 && hz < 2 * t.ez;
}

// PLAIN: store the halo cells no other tile reaches instead of adding them
// atomically.  COPIES: halo copies in shared memory, the warps spread over
// them.  MODE: 0 complete; 1 no block search (a particle's block guessed
// from its index); 2 shared adds without atomics (racy); 3 no mesh flush;
// 4 no particles (zero and flush only).
template <int TX, int TY, int TZ, bool PLAIN, int COPIES, int MODE>
__global__ void __launch_bounds__(kThreads)
deposit_variant(const int* __restrict__ lidx, const float* __restrict__ fx,
                const float* __restrict__ fy, const float* __restrict__ fz,
                const float* __restrict__ q, const int* __restrict__ starts,
                const int* __restrict__ counts, int N, int nb, float* __restrict__ grid) {
  using T = Tile<TX, TY, TZ>;
  __shared__ int pre_s[T::kBlocks + 1], first_s[T::kBlocks], cut_s[T::kBlocks];
  __shared__ int warp_s[kThreads / 32];
  extern __shared__ float halo[];  // COPIES × kCells
  T tile;
  tile.load(starts, counts, N, nb, pre_s, first_s, cut_s, warp_s);
  if (tile.P == 0) return;
  for (int s = threadIdx.x; s < COPIES * T::kCells; s += kThreads) halo[s] = 0.0f;
  __syncthreads();
  float* mine = halo + ((threadIdx.x >> 5) % COPIES) * T::kCells;
  for (int j = threadIdx.x; j < (MODE == 4 ? 0 : tile.P); j += kThreads) {
    const int b = MODE == 1 ? ((j >> 3) & (T::kBlocks - 1)) : tile.block_of(j);
    const int r = MODE == 1 ? (j & 7) : j - tile.pre[b];
    if (r >= tile.cut[b]) continue;
    const int i = tile.first[b] + r;
    const int a = tile.anchor(b, lidx[i]);
    const float f[3] = {fx[i], fy[i], fz[i]};
    const float qv = q[i];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float wx = cx ? f[0] : 1.0f - f[0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const float wy = cy ? f[1] : 1.0f - f[1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const float wz = cz ? f[2] : 1.0f - f[2];
          float* c = mine + a + (cx * T::HY + cy) * T::HZ + cz;
          if (MODE == 2)
            *c += (wx * wy * wz) * qv;
          else
            atomicAdd(c, (wx * wy * wz) * qv);
        }
      }
    }
  }
  __syncthreads();
  if (MODE == 3) return;
  const int n = 2 * nb;
  for (int s = threadIdx.x; s < T::kCells; s += kThreads) {
    long long g;
    if (!tile.cell(s, n, &g)) continue;
    float v = halo[s];
#pragma unroll
    for (int k = 1; k < COPIES; ++k) v += halo[k * T::kCells + s];
    if (v == 0.0f) continue;
    if (PLAIN && interior(tile, s))
      grid[g] = v;
    else
      atomicAdd(grid + g, v);
  }
}

// STAGE: 0 halo loads through registers, 1 asynchronous copies.  MODE: 0
// complete; 1 no block search; 2 no staging; 3 staging only.
template <int TX, int TY, int TZ, int STAGE, int MODE>
__global__ void __launch_bounds__(kThreads)
gather_variant(const int* __restrict__ lidx, const float* __restrict__ fx,
               const float* __restrict__ fy, const float* __restrict__ fz,
               const int* __restrict__ starts, const int* __restrict__ counts, int N, int nb,
               const float* __restrict__ grids, int D, float* __restrict__ out) {
  using T = Tile<TX, TY, TZ>;
  __shared__ int pre_s[T::kBlocks + 1], first_s[T::kBlocks], cut_s[T::kBlocks];
  __shared__ int warp_s[kThreads / 32];
  extern __shared__ float halo[];  // D × kCells
  T tile;
  tile.load(starts, counts, N, nb, pre_s, first_s, cut_s, warp_s);
  if (tile.P == 0) return;
  const int n = 2 * nb;
  const long long n3 = (long long)n * n * n;
  for (int s = threadIdx.x; s < (MODE == 2 ? 0 : T::kCells); s += kThreads) {
    long long g;
    if (!tile.cell(s, n, &g)) continue;
    for (int d = 0; d < D; ++d) {
      if (STAGE)
        __pipeline_memcpy_async(halo + d * T::kCells + s, grids + d * n3 + g, sizeof(float));
      else
        halo[d * T::kCells + s] = grids[d * n3 + g];
    }
  }
  if (STAGE) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < (MODE == 3 ? 0 : tile.P); j += kThreads) {
    const int b = MODE == 1 ? ((j >> 3) & (T::kBlocks - 1)) : tile.block_of(j);
    const int r = MODE == 1 ? (j & 7) : j - tile.pre[b];
    const int i = tile.first[b] + r;
    if (r >= tile.cut[b]) {
      for (int d = 0; d < D; ++d) out[d * (long long)N + i] = 0.0f;
      continue;
    }
    const int a = tile.anchor(b, lidx[i]);
    const float f[3] = {fx[i], fy[i], fz[i]};
    int off[8];
    float wt[8];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float wx = cx ? f[0] : 1.0f - f[0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const float wy = cy ? f[1] : 1.0f - f[1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const float wz = cz ? f[2] : 1.0f - f[2];
          const int k = (cx * 2 + cy) * 2 + cz;
          off[k] = a + (cx * T::HY + cy) * T::HZ + cz;
          wt[k] = wx * wy * wz;
        }
      }
    }
    for (int d = 0; d < D; ++d) {
      const float* S = halo + d * T::kCells;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += wt[k] * S[off[k]];
      out[d * (long long)N + i] = v;
    }
  }
}

typedef int (*DepositFn)(const int*, const float*, const float*, const float*, const float*,
                         const int*, const int*, int, int, float*, cudaStream_t);
typedef int (*GatherFn)(const int*, const float*, const float*, const float*, const int*,
                        const int*, int, int, const float*, int, float*, cudaStream_t);

template <int TX, int TY, int TZ, bool PLAIN, int COPIES, int MODE>
static int deposit_variant_launch(const int* lidx, const float* fx, const float* fy,
                                  const float* fz, const float* q, const int* starts,
                                  const int* counts, int N, int nb, float* grid,
                                  cudaStream_t stream) {
  using T = Tile<TX, TY, TZ>;
  const size_t bytes = sizeof(float) * COPIES * T::kCells;
  auto kernel = deposit_variant<TX, TY, TZ, PLAIN, COPIES, MODE>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  kernel<<<T::count(nb), kThreads, bytes, stream>>>(lidx, fx, fy, fz, q, starts, counts, N, nb,
                                                     grid);
  return (int)cudaGetLastError();
}

template <int TX, int TY, int TZ, int STAGE, int MODE>
static int gather_variant_launch(const int* lidx, const float* fx, const float* fy,
                                 const float* fz, const int* starts, const int* counts, int N,
                                 int nb, const float* grids, int D, float* out,
                                 cudaStream_t stream) {
  using T = Tile<TX, TY, TZ>;
  const size_t bytes = sizeof(float) * D * T::kCells;
  auto kernel = gather_variant<TX, TY, TZ, STAGE, MODE>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  kernel<<<T::count(nb), kThreads, bytes, stream>>>(lidx, fx, fy, fz, starts, counts, N, nb,
                                                     grids, D, out);
  return (int)cudaGetLastError();
}

// Names starting with "split" leave work out and give wrong results.
static const struct {
  DepositFn fn;
  const char* name;
} kDeposit[] = {
    {deposit_launch<float, 4, 8, 8>, "as built (4x8x8)"},
    {deposit_variant_launch<4, 8, 8, true, 1, 0>, "4x8x8, plain stores inside"},
    {deposit_variant_launch<4, 8, 8, false, 8, 0>, "4x8x8, a halo copy per warp"},
    {deposit_variant_launch<4, 8, 8, false, 2, 0>, "4x8x8, two halo copies"},
    {deposit_variant_launch<4, 4, 16, false, 1, 0>, "4x4x16"},
    {deposit_variant_launch<4, 4, 8, false, 1, 0>, "4x4x8"},
    {deposit_variant_launch<8, 4, 8, false, 1, 0>, "8x4x8"},
    {deposit_variant_launch<2, 2, 16, false, 1, 0>, "2x2x16"},
    {deposit_variant_launch<4, 8, 8, false, 1, 1>, "split: no block search"},
    {deposit_variant_launch<4, 8, 8, false, 1, 2>, "split: racy shared adds"},
    {deposit_variant_launch<4, 8, 8, false, 1, 3>, "split: no mesh flush"},
    {deposit_variant_launch<4, 8, 8, false, 1, 4>, "split: zero and flush only"},
};

static const struct {
  GatherFn fn;
  const char* name;
} kGather[] = {
    {gather_launch<float, 4, 4, 8>, "as built (4x4x8, cp.async)"},
    {gather_variant_launch<4, 4, 8, 0, 0>, "4x4x8, staging through registers"},
    {gather_variant_launch<4, 4, 16, 1, 0>, "4x4x16"},
    {gather_variant_launch<4, 8, 8, 1, 0>, "4x8x8"},
    {gather_variant_launch<2, 4, 16, 1, 0>, "2x4x16"},
    {gather_variant_launch<8, 8, 4, 1, 0>, "8x8x4"},
    {gather_variant_launch<4, 4, 8, 1, 1>, "split: no block search"},
    {gather_variant_launch<4, 4, 8, 1, 2>, "split: no staging"},
    {gather_variant_launch<4, 4, 8, 1, 3>, "split: staging only"},
};

extern "C" int deposit_variants() { return sizeof(kDeposit) / sizeof(kDeposit[0]); }
extern "C" int gather_variants() { return sizeof(kGather) / sizeof(kGather[0]); }
extern "C" const char* deposit_variant_name(int v) { return kDeposit[v].name; }
extern "C" const char* gather_variant_name(int v) { return kGather[v].name; }

// The arguments of pm_deposit_launch / pm_gather_launch after the variant.
extern "C" int deposit_variant_run(int v, const int* lidx, const float* fx, const float* fy,
                                   const float* fz, const float* q, const int* starts,
                                   const int* counts, int N, int nb, float* grid, void* stream) {
  return kDeposit[v].fn(lidx, fx, fy, fz, q, starts, counts, N, nb, grid, (cudaStream_t)stream);
}

extern "C" int gather_variant_run(int v, const int* lidx, const float* fx, const float* fy,
                                  const float* fz, const int* starts, const int* counts, int N,
                                  int nb, const float* grids, int D, float* out, void* stream) {
  return kGather[v].fn(lidx, fx, fy, fz, starts, counts, N, nb, grids, D, out,
                       (cudaStream_t)stream);
}

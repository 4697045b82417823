// CIC deposit and gather on 2³-mesh-cell blocks from precomputed per-slot
// geometry: the PM-only path's block kernels.
//
// Replaces concept_tpu/grid/pallas_pm.py
//   _deposit_kernel (:54; deposit_pallas_kc, pallas_call at :139) and
//   _gather_kernel  (:81; gather_pallas_kc, pallas_call at :171).
//
// Inputs are slot-major (K, C), C = nb³ blocks with x-major ids
// c = (bx·nb + by)·nb + bz, nb = n/2, as grid/bucketed.bucketize_blocks
// lays them out: lidx (int32), the slot's CIC anchor in its block's 4³
// halo mini-grid, (lx·4 + ly)·4 + lz with each of lx, ly, lz in [0, 2]
// (a particle is bucketed by its own cell, so its anchor lies within one
// cell of it and no halo test is needed); the CIC fractions fx, fy, fz;
// and q (deposit: the weight, premasked by validity) or w (gather: the
// validity weight).  The global anchor is 2·(bx, by, bz) − 1 + (lx, ly,
// lz), taken modulo n.
//
// What bounds them on the card: device memory.  A slot moves 20 bytes in
// (lidx, fx, fy, fz, q) and makes 8 atomic corner updates (deposit), or
// 8·D corner reads and D floats out (gather), for ~30 FP32 operations.
// Design: one thread per slot, neighbouring threads on neighbouring
// blocks, so the slot-major reads and the gather's writes are coalesced.
// The deposit adds its 8 corner weights atomically straight into the
// periodic n³ mesh, which takes the place of the TPU kernels' 64-cell
// one-hot mini-grids and their overlap-add band contractions
// (_assemble_global_T); slots of weight 0 return at once.  The corner
// weight is formed in the TPU kernel's order, (wx·wy·wz)·q.  Atomics add
// in no fixed order.
#include <cuda_runtime.h>

struct Anchor {
  int ix, iy, iz;  // global anchor mesh indices, in [−1, n − 1]
};

__device__ __forceinline__ Anchor decode(int l, long long i, int nb) {
  const int C = nb * nb * nb;
  const int c = (int)(i % C);
  Anchor a;
  a.ix = 2 * (c / (nb * nb)) - 1 + (l >> 4);
  a.iy = 2 * ((c / nb) % nb) - 1 + ((l >> 2) & 3);
  a.iz = 2 * (c % nb) - 1 + (l & 3);
  return a;
}

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

__global__ void pm_deposit_kernel(const int* __restrict__ lidx,
                                  const float* __restrict__ fx,
                                  const float* __restrict__ fy,
                                  const float* __restrict__ fz,
                                  const float* __restrict__ q, long long KC, int nb,
                                  float* __restrict__ grid) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const float qv = q[i];
  if (qv == 0.0f) return;
  const Anchor a = decode(lidx[i], i, nb);
  const float f[3] = {fx[i], fy[i], fz[i]};
  const int n = 2 * nb;
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const float wx = cx ? f[0] : 1.0f - f[0];
    const long long ox = (long long)wrap(a.ix + cx, n) * n;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const float wy = cy ? f[1] : 1.0f - f[1];
      const long long oy = (ox + wrap(a.iy + cy, n)) * n;
#pragma unroll
      for (int cz = 0; cz < 2; ++cz) {
        const float wz = cz ? f[2] : 1.0f - f[2];
        atomicAdd(grid + oy + wrap(a.iz + cz, n), (wx * wy * wz) * qv);
      }
    }
  }
}

__global__ void pm_gather_kernel(const int* __restrict__ lidx,
                                 const float* __restrict__ fx,
                                 const float* __restrict__ fy,
                                 const float* __restrict__ fz,
                                 const float* __restrict__ w, long long KC, int nb,
                                 const float* __restrict__ grids, int D,
                                 float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const float wv = w[i];
  const int n = 2 * nb;
  const long long n3 = (long long)n * n * n;
  if (wv == 0.0f) {
    for (int dd = 0; dd < D; ++dd) out[dd * KC + i] = 0.0f;
    return;
  }
  const Anchor a = decode(lidx[i], i, nb);
  const float f[3] = {fx[i], fy[i], fz[i]};
  // the 8 corners' mesh offsets and weights, shared by the D fields
  long long off[8];
  float wt[8];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const float wx = cx ? f[0] : 1.0f - f[0];
    const long long ox = (long long)wrap(a.ix + cx, n) * n;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const float wy = cy ? f[1] : 1.0f - f[1];
      const long long oy = (ox + wrap(a.iy + cy, n)) * n;
#pragma unroll
      for (int cz = 0; cz < 2; ++cz) {
        const float wz = cz ? f[2] : 1.0f - f[2];
        const int k = (cx * 2 + cy) * 2 + cz;
        off[k] = oy + wrap(a.iz + cz, n);
        wt[k] = (wx * wy * wz) * wv;
      }
    }
  }
  for (int dd = 0; dd < D; ++dd) {
    const float* G = grids + dd * n3;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) v += wt[k] * G[off[k]];
    out[dd * KC + i] = v;
  }
}

// lidx (int32), fx, fy, fz, q: (K, C) contiguous, C = nb³; grid (n, n, n)
// contiguous, n = 2·nb, zeroed by the caller.  Returns the cudaError_t of
// the launch.
extern "C" int pm_deposit_launch(const int* lidx, const float* fx, const float* fy,
                                 const float* fz, const float* q, int K, int nb,
                                 float* grid, void* stream) {
  const long long KC = (long long)K * nb * nb * nb;
  const int threads = 256;
  const long long blocks = (KC + threads - 1) / threads;
  pm_deposit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      lidx, fx, fy, fz, q, KC, nb, grid);
  return (int)cudaGetLastError();
}

// the same slot arrays with the validity weight w; grids (D, n, n, n)
// contiguous; out (D, K, C) contiguous.
extern "C" int pm_gather_launch(const int* lidx, const float* fx, const float* fy,
                                const float* fz, const float* w, int K, int nb,
                                const float* grids, int D, float* out, void* stream) {
  const long long KC = (long long)K * nb * nb * nb;
  const int threads = 256;
  const long long blocks = (KC + threads - 1) / threads;
  pm_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      lidx, fx, fy, fz, w, KC, nb, grids, D, out);
  return (int)cudaGetLastError();
}

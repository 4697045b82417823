// CIC deposit and gather straight from the (K, C) cell layout.
//
// Replaces concept_tpu/grid/pallas_cells.py
//   _deposit_kernel_cells (pallas_call at :284) and
//   _gather_kernel_cells  (pallas_call at :341).
//
// Cells are cb mesh cells wide, C = nc³ with ids (cx·nc + cy)·nc + cz.
// A slot takes part only when its CIC cloud lies inside its cell's
// ±1-mesh-cell halo, the test of _cell_geometry (pallas_cells.py:133): the
// TPU kernels fill a (cb+2)³ mini-grid per cell and drop the rest, so the
// deposited mass falls short exactly when a particle drifted out of its
// column's halo, which the rung stepper checks (mass_sum).  Unlike
// _cell_geometry, the test here is periodic: a particle that crossed a
// box face is wrapped to the far side of the box but still lies in its
// column's halo, and is kept.
//
// What bounds them on the card: device memory.  A slot moves 16 bytes in
// (x, y, z, w), 8 atomic corner updates (deposit) or 8·D corner reads and
// D floats out (gather), for ~30 FP32 operations.
// Design: one thread per slot, neighbouring threads on neighbouring
// columns, so slot reads and gather writes are coalesced.  The deposit
// atomically adds the 8 corner weights straight into the periodic n³
// mesh, which takes the place of the TPU's mini-grids and their
// overlap-add band contractions; neighbouring slots share mesh lines, so
// the corners mostly hit L2.  Atomics add in no fixed order.
#include <cuda_runtime.h>

struct Geometry {
  int ix, iy, iz;  // anchor mesh indices (unwrapped, ≥ −1)
  float fx, fy, fz;
  bool in_halo;
};

__device__ __forceinline__ Geometry cell_geometry(float px, float py, float pz,
                                                  int c, int nc, int cb,
                                                  float inv_h) {
  // round-to-nearest intrinsics keep u = p·inv_h − ½ unfused, as the
  // reference and the plain version form it, so the halo test agrees
  const int cz = c % nc, cy = (c / nc) % nc, cx = c / (nc * nc);
  Geometry g;
  const float ux = __fadd_rn(__fmul_rn(px, inv_h), -0.5f);
  const float uy = __fadd_rn(__fmul_rn(py, inv_h), -0.5f);
  const float uz = __fadd_rn(__fmul_rn(pz, inv_h), -0.5f);
  const float ax = floorf(ux), ay = floorf(uy), az = floorf(uz);
  g.fx = __fsub_rn(ux, ax);
  g.fy = __fsub_rn(uy, ay);
  g.fz = __fsub_rn(uz, az);
  g.ix = (int)ax;
  g.iy = (int)ay;
  g.iz = (int)az;
  // periodic halo test: a slot that crossed a box face since the last
  // rebucket sits at the far side of [0, boxsize), its anchor in the halo
  // modulo the mesh (anchors lie in [−1, n−1], so one +n suffices)
  const int n = nc * cb;
  const int lx = (g.ix - cx * cb + 1 + n) % n;
  const int ly = (g.iy - cy * cb + 1 + n) % n;
  const int lz = (g.iz - cz * cb + 1 + n) % n;
  g.in_halo = lx <= cb && ly <= cb && lz <= cb;
  return g;
}

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

__global__ void deposit_cells_kernel(const float* __restrict__ pos, long long pos_cs,
                                     const float* __restrict__ w, long long KC,
                                     int nc, int cb, float inv_h,
                                     float* __restrict__ grid) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const float q = w[i];
  if (q == 0.0f) return;
  const int C = nc * nc * nc;
  const Geometry g = cell_geometry(pos[i], pos[pos_cs + i], pos[2 * pos_cs + i],
                                   (int)(i % C), nc, cb, inv_h);
  if (!g.in_halo) return;
  const int n = nc * cb;
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

__global__ void gather_cells_kernel(const float* __restrict__ pos, long long pos_cs,
                                    const float* __restrict__ w, long long KC,
                                    int nc, int cb, float inv_h,
                                    const float* __restrict__ grids, int D,
                                    float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const int C = nc * nc * nc;
  // slots of weight 0 (invalid ones may hold the far sentinel) skip the
  // geometry and gather 0
  float q = w[i];
  Geometry g = {};
  if (q != 0.0f) {
    g = cell_geometry(pos[i], pos[pos_cs + i], pos[2 * pos_cs + i], (int)(i % C), nc, cb,
                      inv_h);
    if (!g.in_halo) q = 0.0f;
  }
  const int n = nc * cb;
  const long long n3 = (long long)n * n * n;
  for (int dd = 0; dd < D; ++dd) {
    float v = 0.0f;
    if (q != 0.0f) {
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

// pos (3, K, C) float32 with rows contiguous (row stride C) and component
// stride pos_cs; w (K, C) contiguous; grid (n, n, n) contiguous, zeroed by
// the caller.  Returns the cudaError_t of the launch.
extern "C" int deposit_cells_launch(const float* pos, long long pos_cs,
                                    const float* w, int K, int nc, int cb,
                                    float inv_h, float* grid, void* stream) {
  const long long KC = (long long)K * nc * nc * nc;
  const int threads = 256;
  const long long blocks = (KC + threads - 1) / threads;
  deposit_cells_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pos, pos_cs, w, KC, nc, cb, inv_h, grid);
  return (int)cudaGetLastError();
}

// grids (D, n, n, n) contiguous; out (D, K, C) contiguous.
extern "C" int gather_cells_launch(const float* pos, long long pos_cs,
                                   const float* w, int K, int nc, int cb,
                                   float inv_h, const float* grids, int D,
                                   float* out, void* stream) {
  const long long KC = (long long)K * nc * nc * nc;
  const int threads = 256;
  const long long blocks = (KC + threads - 1) / threads;
  gather_cells_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pos, pos_cs, w, KC, nc, cb, inv_h, grids, D, out);
  return (int)cudaGetLastError();
}

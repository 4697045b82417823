// One-sided P³M short-range pair sweep on the (K, C) slot layout.
//
// Replaces concept_tpu/forces/pallas_shortrange.py
//   _make_pair_kernel_flat_bounded (pallas_call at :714) and
//   _make_pair_kernel_flat         (pallas_call at :798),
// with the shared pair math of _make_accum / _force_law / screening_g.
//
// What it computes: for every receiver slot (row r < K_r of column c) the
// sum over the supplier slots (rows s < K_s) of the 27 periodic
// neighbour columns of −S(r/rₛ)·r⁻³_soft·(x_r − x_s), counting a pair only
// when 0 < r² < cutoff².  Columns are cells of an n³ grid with x-major,
// z-fastest ids; a neighbour across a box face is seen at ±boxsize.
// Invalid slots hold the far sentinel 1e4·boxsize, so the cutoff mask
// removes them; coincident sentinels give r² = 0, removed by r² > 0.
// Optional per-pencil row bounds (rext, sext; pencil = ci·n + cj): rows of
// column c at or beyond rext[pencil(c)] output exactly 0, and suppliers at
// or beyond the max of sext over the 9 neighbouring pencils are skipped.
//
// What bounds it on the card: FP32 operations.  A pair costs ~40 FP32
// operations (an FMA counted as 2) and a rsqrt, against 12 bytes of
// supplier data that a block reuses for all of its receiver rows.
// Design: one block per receiver column, one thread per receiver row with
// its sum in registers (columns deeper than 256 rows take several passes).
// The block stages each neighbour column's supplier rows in shared memory,
// 512 rows at a time (the ±box wrap applied while staging), so a supplier
// row is read from device memory once per neighbouring column and pass
// and then reused by every receiver row of the block; all threads read
// the same staged row, a broadcast.  Rows and whole columns beyond the
// bounds do no pair work.  No tensor cores: the pair force is not a
// matrix product.
#include <cuda_runtime.h>

#define NCOEF 11
#define U_MAX 21.16f  // (4.6)², the fit range of the screening polynomial

struct GCoef {
  float c[NCOEF];  // Horner coefficients of g(t), highest degree first
};

enum { KERNEL_PLUMMER = 0, KERNEL_SPLINE = 1, KERNEL_NONE = 2 };

__device__ __forceinline__ float screening_g(float u, const GCoef& gc) {
  // g(u) = (S(√u) − 1)/√u, u clamped into the fit (keeps sentinels finite)
  const float t = fminf(2.0f * u / U_MAX - 1.0f, 1.0f);
  float g = gc.c[0];
#pragma unroll
  for (int i = 1; i < NCOEF; ++i) g = g * t + gc.c[i];
  return g;
}

#define TILE 512     // supplier rows staged in shared memory at a time
#define THREADS 256  // receiver rows per pass, at most

__global__ void __launch_bounds__(THREADS) pair_sweep_kernel(
    const float* __restrict__ recv, long long recv_cs, int K_r,
    const float* __restrict__ sup, long long sup_cs, int K_s, int n,
    const int* __restrict__ rext, const int* __restrict__ sext,
    float* __restrict__ out, float boxsize, float inv_scale, float cutoff2,
    float soft2, int kernel, GCoef gc) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE];
  const long long C = (long long)n * n * n;
  const long long oc = (long long)K_r * C;
  const int c = blockIdx.x;
  const int ci = c / (n * n), cj = (c / n) % n, ck = c % n;
  int rb = K_r, sb = K_s;
  if (rext != nullptr) {
    rb = min(rext[ci * n + cj], K_r);
    int m = 0;
    for (int di = -1; di <= 1; ++di)
      for (int dj = -1; dj <= 1; ++dj)
        m = max(m, sext[((ci + di + n) % n) * n + (cj + dj + n) % n]);
    sb = min(m, K_s);
  }
  // rows at or beyond the bound write exactly 0
  for (int r = rb + threadIdx.x; r < K_r; r += blockDim.x) {
    out[(long long)r * C + c] = 0.0f;
    out[oc + (long long)r * C + c] = 0.0f;
    out[2 * oc + (long long)r * C + c] = 0.0f;
  }
  const float inv_scale2 = inv_scale * inv_scale;
  // GADGET-2 spline: h = 2.8ε (soft2 = ε²)
  const float h2 = 7.84f * soft2;
  const float h = 2.8f * sqrtf(soft2);
  const float inv_h = h > 0.0f ? 1.0f / fmaxf(h, 1e-30f) : 1e30f;
  // one pass per blockDim.x receiver rows (bounds are uniform over the block)
  for (int r0 = 0; r0 < rb; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const bool own = r < rb;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f;
    if (own) {
      ox = recv[(long long)r * C + c];
      oy = recv[recv_cs + (long long)r * C + c];
      oz = recv[2 * recv_cs + (long long)r * C + c];
    }
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    for (int nb = 0; nb < 27 && sb > 0; ++nb) {
      int ni = ci + nb / 9 - 1, nj = cj + (nb / 3) % 3 - 1, nk = ck + nb % 3 - 1;
      const float shx = ni < 0 ? -boxsize : (ni >= n ? boxsize : 0.0f);
      const float shy = nj < 0 ? -boxsize : (nj >= n ? boxsize : 0.0f);
      const float shz = nk < 0 ? -boxsize : (nk >= n ? boxsize : 0.0f);
      ni = (ni + n) % n;
      nj = (nj + n) % n;
      nk = (nk + n) % n;
      const long long col = ((long long)ni * n + nj) * n + nk;
      for (int s0 = 0; s0 < sb; s0 += TILE) {
        const int ns = min(TILE, sb - s0);
        __syncthreads();  // the previous tile is consumed
        for (int s = threadIdx.x; s < ns; s += blockDim.x) {
          const long long at = (long long)(s0 + s) * C + col;
          sx[s] = sup[at] + shx;
          sy[s] = sup[sup_cs + at] + shy;
          sz[s] = sup[2 * sup_cs + at] + shz;
        }
        __syncthreads();
        if (!own) continue;
        for (int s = 0; s < ns; ++s) {
          const float dx = ox - sx[s];
          const float dy = oy - sy[s];
          const float dz = oz - sz[s];
          // unfused, in the plain version's order: the force jumps at the
          // cutoff, so both must take the same pairs
          const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          if (!(r2 < cutoff2 && r2 > 0.0f)) continue;
          float f;
          if (kernel == KERNEL_PLUMMER) {
            const float r2s = r2 + soft2;
            const float inv_r = rsqrtf(r2s);
            const float g = screening_g(r2s * inv_scale2, gc);
            f = -(inv_r * inv_r * (inv_r + inv_scale * g));
          } else {
            const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
            const float inv_r2 = inv_r * inv_r;
            const float g = screening_g(r2 * inv_scale2, gc);
            f = -(inv_r2 * (inv_r + inv_scale * g));
            if (kernel == KERNEL_SPLINE && r2 < h2) {
              // near-field spline correction (_make_accum's near_m branch)
              const float rr = r2 * inv_r;
              const float S = 1.0f + (rr * inv_scale) * g;
              const float far = inv_r2 * inv_r;
              const float u = rr * inv_h;
              const float near = 32.0f * inv_h * inv_h * inv_h *
                                 (1.0f / 3.0f + u * u * (-6.0f / 5.0f + u));
              const float mid = (32.0f / 3.0f) * far *
                                (u * u * u * (2.0f + u * (-4.5f + u * (3.6f - u))) -
                                 3.0f / 480.0f);
              f -= S * ((u < 0.5f ? near : mid) - far);
            }
          }
          ax += f * dx;
          ay += f * dy;
          az += f * dz;
        }
      }
    }
    if (own) {
      out[(long long)r * C + c] = ax;
      out[oc + (long long)r * C + c] = ay;
      out[2 * oc + (long long)r * C + c] = az;
    }
  }
}

// recv (3, K_r, C) and sup (3, K_s, C) float32, rows contiguous with row
// stride C and component strides recv_cs / sup_cs; out (3, K_r, C)
// contiguous.  rext/sext: (n²,) int32 device arrays or both null.  coef:
// host array of NCOEF floats.  Returns the cudaError_t of the launch.
extern "C" int pair_sweep_launch(const float* recv, long long recv_cs, int K_r,
                                 const float* sup, long long sup_cs, int K_s,
                                 int n, const int* rext, const int* sext,
                                 float* out, float boxsize, float inv_scale,
                                 float cutoff2, float soft2, int kernel,
                                 const float* coef, void* stream) {
  GCoef gc;
  for (int i = 0; i < NCOEF; ++i) gc.c[i] = coef[i];
  const int rows = ((K_r + 31) / 32) * 32;
  const int threads = rows < THREADS ? rows : THREADS;
  pair_sweep_kernel<<<n * n * n, threads, 0, (cudaStream_t)stream>>>(
      recv, recv_cs, K_r, sup, sup_cs, K_s, n, rext, sext, out, boxsize,
      inv_scale, cutoff2, soft2, kernel, gc);
  return (int)cudaGetLastError();
}

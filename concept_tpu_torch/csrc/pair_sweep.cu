// One-sided P³M short-range pair sweep on the (K, C) slot layout.
//
// Replaces concept_tpu/forces/pallas_shortrange.py
//   _make_pair_kernel_flat_bounded (pallas_call at :714),
//   _make_pair_kernel_flat         (pallas_call at :798),
//   _make_pair_kernel_reach        (pallas_call at :1103),
//   _make_kernel_reach             (pallas_call at :965) and
//   _make_kernel                   (pallas_call at :1163),
// with the shared pair math of _make_accum / _force_law / screening_g.
//
// What it computes: for every receiver slot (row r < K_r of column c) the
// sum over the supplier slots (rows s < K_s) of the neighbour columns
// c + d, d in the launch's offset table, of −S(r/rₛ)·r⁻³_soft·(x_r − x_s),
// counting a pair only when 0 < r² < cutoff².  The table is the 27
// offsets of |d| ≤ 1 for cells at least a cutoff wide, or the kept
// offsets of |d| ≤ 2 (kept_offsets: 117 of 125) for the rung stepper's
// cells 4 mesh cells wide, which are narrower than the cutoff.  Columns
// are cells of an nx × n × n grid with x-major, z-fastest ids (nx = n: the
// whole box; else a rank's planes of columns between the neighbour planes
// it received, one a side for the ±1 table (nx = planes + 2) and two for
// the reach table (nx = planes + 4), which the rank's row bounds leave
// without receivers, so that no kept receiver reaches the wrap along x);
// a neighbour across a face of the grid is seen at ±boxsize (for |d| ≤ 2
// and n, nx ≥ 5 every offset of a column names a distinct column: a rank
// holds at least 2 planes of the reach layout, so nx ≥ 6).  Invalid slots hold a far sentinel
// (±1e4·boxsize), so the cutoff mask removes them; coincident sentinels
// give r² = 0, removed by r² > 0.  Optional per-column row bounds rb, sb
// (C,): rows of column c at or beyond rb[c] output exactly 0, and the
// supplier rows of a neighbour column at or beyond its sb are skipped.
//
// What bounds it on the card: FP32 operations.  A pair test costs ~8
// FP32 operations (with its loads and compares ~12 lane-instructions), a
// pair inside the cutoff ~40 more and a rsqrt, against 12 bytes of
// supplier data that every receiver of a column reuses.  Only ~5-10 % of
// the tested pairs fall inside the cutoff, and the first version of this
// kernel ran the force inline under the test: a warp took the force path
// whenever one of its 32 receivers passed, which cost it 59 % of its time
// at the 8-mesh-cell layout (scripts/torch_sweep_split.py).  Both designs
// below therefore test 32 staged rows per lane into a pass mask, queue the
// (block, mask) entries that hold a pass per lane in shared memory (QUEUE
// of them), and drain the queues when one is full or the staged rows are
// about to be replaced: there each lane walks its own passing pairs, so
// the force path runs on pairs inside the cutoff only and a lane's sum
// stays in its registers.  Lanes without a receiver hold NaN, which fails
// every test.  Rows beyond a column's receiver bound do no work at all.
// No tensor cores: the pair force is not a matrix product.
// - The ±1 table (pair_sweep_kernel; columns of ~64 rows and 27
//   neighbours at the 8-mesh-cell layout): one block per receiver column,
//   one thread per receiver row (several passes past THREADS rows).  The
//   block reads its 27 neighbours' row counts at once, stages their
//   supplier rows, compacted by sb and with the ±box wrap applied, TILE
//   rows at a time as float4 (one load a test), and every warp that holds
//   a receiver tests all of them (a broadcast read).  Two block barriers
//   per tile.
// - The reach table (pair_sweep_kernel_reach; columns of ~8 rows and 117
//   neighbours at the 4-mesh-cell layout): a block per receiver column
//   leaves most of its lanes idle and pays two barriers per neighbour.  So
//   one warp per receiver column, WARPS columns (consecutive in z, whose
//   neighbourhoods overlap in L1) a block, at least 8 blocks resident on
//   an SM, and no block barrier: the warp
//   stages its own neighbourhood, CAP rows at a time (one lane per
//   neighbour column, whose neighbours in z are neighbours in memory, a
//   warp scan for the places; the lanes over the rows of a deep column; a
//   column deeper than the room left is split across stagings), and splits
//   its lanes as R ≤ 32 receivers × ⌊32/R⌋ groups of staged rows (lane =
//   g·R + ρ, group g testing rows g, g + G, …), so that 8 receivers keep
//   32 lanes busy; shuffles add the groups' sums at the end.
// r² is formed unfused, in the plain version's order: the force jumps at
// the cutoff, so the kernel and the plain version must take the same
// pairs.
//
// The global steppers' sweeps without a rung bound (rows 6 and 2, the
// ±1 table over whole columns) take a third design, pair_sweep_global_kernel
// (below, at its definition).
//
// All three kernels are templates on the scalar type, instantiated for
// float and double (the _f64 launch functions).  The double kernels evaluate
// the screening exactly, erfc and exp as the float64 plain version does,
// where the float ones take the degree-10 fit; they stage 32-byte rows
// (two shared loads a test), and the reach kernel's double instantiation
// asks for 4 resident blocks, not 8, so that its registers need not
// spill.  Its staged rows (4 warps × 256 rows × 32 bytes) and queues
// take 38.5 KB of static shared memory, under the 48 KB limit.  In
// double the sweep is bound by FP64 operations (half the FP32 rate).
#include <cuda_runtime.h>

#include <cmath>

#define NCOEF 11
#define U_MAX 21.16f  // (4.6)², the fit range of the screening polynomial

struct GCoef {
  float c[NCOEF];  // Horner coefficients of g(t), highest degree first
};

enum { KERNEL_PLUMMER = 0, KERNEL_SPLINE = 1, KERNEL_NONE = 2 };

// The scalar type's staged row (x, y, z and a pad, one 16-byte load in
// float), its NaN and its round-to-nearest product and sum.
template <typename T>
struct Num;

template <>
struct Num<float> {
  using Row = float4;
  static __device__ __forceinline__ float4 row(float x, float y, float z) {
    return make_float4(x, y, z, 0.0f);
  }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fffffff); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Num<double> {
  struct __align__(16) Row {
    double x, y, z, w;
  };
  static __device__ __forceinline__ Row row(double x, double y, double z) {
    Row r;
    r.x = x;
    r.y = y;
    r.z = z;
    r.w = 0.0;
    return r;
  }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7fffffffffffffffLL);
  }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};

__device__ __forceinline__ float screening_g(float u, const GCoef& gc) {
  // g(u) = (S(√u) − 1)/√u, u clamped into the fit (keeps sentinels finite)
  const float t = fminf(2.0f * u / U_MAX - 1.0f, 1.0f);
  float g = gc.c[0];
#pragma unroll
  for (int i = 1; i < NCOEF; ++i) g = g * t + gc.c[i];
  return g;
}

template <typename T>
struct ForceLaw {
  int kernel;
  T inv_scale, inv_scale2, h2, inv_h;
  T soft2;
};

// −S(r/rₛ)·r⁻³_soft for a pair inside the cutoff (_make_accum)
__device__ __forceinline__ float pair_factor(float r2, const ForceLaw<float>& L,
                                             const GCoef& gc) {
  if (L.kernel == KERNEL_PLUMMER) {
    const float r2s = r2 + L.soft2;
    const float inv_r = rsqrtf(r2s);
    const float g = screening_g(r2s * L.inv_scale2, gc);
    return -(inv_r * inv_r * (inv_r + L.inv_scale * g));
  }
  const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
  const float inv_r2 = inv_r * inv_r;
  const float g = screening_g(r2 * L.inv_scale2, gc);
  float f = -(inv_r2 * (inv_r + L.inv_scale * g));
  if (L.kernel == KERNEL_SPLINE && r2 < L.h2) {
    // near-field spline correction (_make_accum's near_m branch)
    const float rr = r2 * inv_r;
    const float S = 1.0f + (rr * L.inv_scale) * g;
    const float far = inv_r2 * inv_r;
    const float u = rr * L.inv_h;
    const float near = 32.0f * L.inv_h * L.inv_h * L.inv_h *
                       (1.0f / 3.0f + u * u * (-6.0f / 5.0f + u));
    const float mid = (32.0f / 3.0f) * far *
                      (u * u * u * (2.0f + u * (-4.5f + u * (3.6f - u))) -
                       3.0f / 480.0f);
    f -= S * ((u < 0.5f ? near : mid) - far);
  }
  return f;
}

// The same in double with the exact screening S(x) = erfc(x/2) +
// x/√π·e^(−x²/4), in the float64 plain version's form: S at the softened
// r for 'plummer', else S·r⁻³_soft (the GADGET-2 spline below h).
__device__ __forceinline__ double pair_factor(double r2, const ForceLaw<double>& L,
                                              const GCoef&) {
  const double r2s = L.kernel == KERNEL_PLUMMER ? r2 + L.soft2 : fmax(r2, 1e-30);
  const double inv_r = rsqrt(r2s);
  const double r = r2s * inv_r;
  const double x = r * L.inv_scale;
  const double S = erfc(0.5 * x) + x * 0.56418958354775628695 * exp(-0.25 * x * x);
  double r3 = inv_r * inv_r * inv_r;
  if (L.kernel == KERNEL_SPLINE && r2 < L.h2) {
    const double u = r * L.inv_h;
    r3 = u < 0.5 ? 32.0 * L.inv_h * L.inv_h * L.inv_h * (1.0 / 3.0 + u * u * (-6.0 / 5.0 + u))
                 : (32.0 / 3.0) * r3 *
                       (u * u * u * (2.0 + u * (-4.5 + u * (3.6 - u))) - 3.0 / 480.0);
  }
  return -S * r3;
}

// unfused, in the plain version's order
template <typename T>
__device__ __forceinline__ T dist2(T dx, T dy, T dz) {
  using N = Num<T>;
  return N::add(N::add(N::mul(dx, dx), N::mul(dy, dy)), N::mul(dz, dz));
}

#define THREADS 256      // ±1 kernel: receiver rows per pass, at most
#define TILE 512         // ±1 kernel: supplier rows staged at a time
#define WARPS 4          // reach kernel: receiver columns per block, a warp each
#define CAP 256          // reach kernel: supplier rows a warp stages at a time
#define QUEUE 8          // (32-test block, pass mask) entries a lane queues
#define MAX_OFFSETS 125  // (2·2 + 1)³: reach 2
#define FULL 0xffffffffu

struct Offsets {
  int count;
  signed char d[3 * MAX_OFFSETS];  // (di, dj, dk) triples
};

template <typename T>
struct Geometry {
  const T* sup;
  long long sup_cs, C;
  int K_s, n, nx;  // C = nx·n² columns
  const int* sb;
  T boxsize;
};

// Column id and ±box shift of the neighbour c + d of column (ci, cj, ck).
template <typename T>
__device__ __forceinline__ int neighbour(const Geometry<T>& G, int ci, int cj,
                                         int ck, const signed char* d,
                                         T& hx, T& hy, T& hz) {
  const int n = G.n, nx = G.nx;
  int ni = ci + d[0], nj = cj + d[1], nk = ck + d[2];
  hx = ni < 0 ? -G.boxsize : (ni >= nx ? G.boxsize : T(0));
  hy = nj < 0 ? -G.boxsize : (nj >= n ? G.boxsize : T(0));
  hz = nk < 0 ? -G.boxsize : (nk >= n ? G.boxsize : T(0));
  ni = (ni + nx) % nx;
  nj = (nj + n) % n;
  nk = (nk + n) % n;
  return (ni * n + nj) * n + nk;
}

template <typename T>
__device__ __forceinline__ void stage_row(const Geometry<T>& G, int row, int col,
                                          T hx, T hy, T hz,
                                          typename Num<T>::Row* q, int at) {
  const long long a = (long long)row * G.C + col;
  q[at] = Num<T>::row(G.sup[a] + hx, G.sup[G.sup_cs + a] + hy,
                      G.sup[2 * G.sup_cs + a] + hz);
}

// A lane's receiver and its sum.  A lane without a receiver holds NaN,
// which fails every test.
template <typename T>
struct Receiver {
  using Row = typename Num<T>::Row;
  T ox, oy, oz, ax, ay, az;

  __device__ __forceinline__ Receiver(const T* recv, long long cs,
                                      long long at, bool own)
      : ax(0), ay(0), az(0) {
    ox = oy = oz = Num<T>::nan();
    if (own) {
      ox = recv[at];
      oy = recv[cs + at];
      oz = recv[2 * cs + at];
    }
  }

  // bit u of m is set for a pair with the staged row p inside the cutoff
  __device__ __forceinline__ void test(Row p, T cutoff2, int u,
                                       unsigned& m) const {
    const T r2 = dist2(ox - p.x, oy - p.y, oz - p.z);
    if (r2 < cutoff2 && r2 > T(0)) m |= 1u << u;
  }

  __device__ __forceinline__ void add(Row p, const ForceLaw<T>& law,
                                      const GCoef& gc) {
    const T dx = ox - p.x, dy = oy - p.y, dz = oz - p.z;
    const T f = pair_factor(dist2(dx, dy, dz), law, gc);
    ax += f * dx;
    ay += f * dy;
    az += f * dz;
  }
};

// A lane's queue of tested 32-blocks with at least one pair inside the
// cutoff: the block's first staged index and its pass mask; entries
// `stride` apart in shared memory.
struct Queue {
  unsigned* mask;
  unsigned short* base;
  int stride, cnt;

  __device__ __forceinline__ void push(unsigned m, int s0) {
    if (m) {
      mask[cnt * stride] = m;
      base[cnt * stride] = (unsigned short)s0;
      ++cnt;
    }
  }

  // Adds the forces of the queued pairs to the receiver's sum and empties
  // the queue; bit u of a block at s0 is the staged row s0 + u·step + off.
  // One pair an iteration of one loop, each lane at its own pace (nested
  // loops over entries and bits would reconverge after every entry).
  template <typename T>
  __device__ __forceinline__ void drain(int step, int off,
                                        const typename Num<T>::Row* q,
                                        Receiver<T>& R, const ForceLaw<T>& law,
                                        const GCoef& gc) {
    int e = 0, s0 = 0;
    unsigned m = 0;
    while (true) {
      if (m == 0) {
        if (e == cnt) break;
        m = mask[e * stride];
        s0 = base[e * stride] + off;
        ++e;
      }
      R.add(q[s0 + (__ffs(m) - 1) * step], law, gc);
      m &= m - 1;
    }
    cnt = 0;
  }
};

// The ±1 table (27 columns of ~64 rows at the 8-mesh-cell layout): one
// block per receiver column, one thread per receiver row (several passes
// past THREADS rows); the block stages its neighbourhood's supplier rows,
// compacted by sb, TILE rows at a time, and every warp that holds a
// receiver tests all of them (a broadcast read).  Dynamic shared memory:
// the lanes' queues, QUEUE × blockDim entries of 6 bytes.
template <typename T>
__global__ void __launch_bounds__(THREADS) pair_sweep_kernel(
    const T* __restrict__ recv, long long recv_cs, int K_r, Geometry<T> G,
    const int* __restrict__ rbound, T* __restrict__ out, T cutoff2,
    ForceLaw<T> law, GCoef gc, Offsets offs) {
  __shared__ typename Num<T>::Row tile[TILE];
  __shared__ signed char table[3 * MAX_OFFSETS];
  __shared__ int nrows[MAX_OFFSETS];
  extern __shared__ unsigned queue_mem[];
  const int n_off = offs.count;
  for (int i = threadIdx.x; i < 3 * n_off; i += blockDim.x) table[i] = offs.d[i];
  __syncthreads();

  const int n = G.n;
  const long long C = G.C;
  const long long c = blockIdx.x;
  const long long oc = (long long)K_r * C;
  const int ci = (int)(c / ((long long)n * n)), cj = (int)((c / n) % n),
            ck = (int)(c % n);
  // the neighbour columns and their supplier rows, read all at once
  for (int j = threadIdx.x; j < n_off; j += blockDim.x) {
    T hx, hy, hz;
    const int col = neighbour(G, ci, cj, ck, table + 3 * j, hx, hy, hz);
    nrows[j] = G.sb ? min(G.sb[col], G.K_s) : G.K_s;
  }
  __syncthreads();
  const int rb = rbound ? max(0, min(rbound[c], K_r)) : K_r;
  // rows at or beyond the bound write exactly 0
  for (int r = rb + threadIdx.x; r < K_r; r += blockDim.x) {
    out[(long long)r * C + c] = T(0);
    out[oc + (long long)r * C + c] = T(0);
    out[2 * oc + (long long)r * C + c] = T(0);
  }
  Queue Q{queue_mem + threadIdx.x,
          (unsigned short*)(queue_mem + QUEUE * blockDim.x) + threadIdx.x,
          (int)blockDim.x, 0};
  const T far = T(1e30);  // pads a tile to whole 32-blocks
  for (int r0 = 0; r0 < rb; r0 += blockDim.x) {
    const long long r = r0 + threadIdx.x;
    // warps with no receiver in this pass only help to stage
    const bool warp_live = r0 + (int)(threadIdx.x & ~31u) < rb;
    Receiver<T> R(recv, recv_cs, r * C + c, r < rb);
    int nb = 0, row = 0;
    while (nb < n_off) {
      int total = 0;
      while (nb < n_off && total < TILE) {  // uniform over the block
        T hx, hy, hz;
        const int col = neighbour(G, ci, cj, ck, table + 3 * nb, hx, hy, hz);
        const int left = nrows[nb] - row;
        const int take = max(0, min(left, TILE - total));
        for (int t = threadIdx.x; t < take; t += blockDim.x)
          stage_row(G, row + t, col, hx, hy, hz, tile, total + t);
        total += take;
        if (take < left) {
          row += take;
        } else {
          ++nb;
          row = 0;
        }
      }
      const int padded = (total + 31) & ~31;
      for (int t = total + threadIdx.x; t < padded; t += blockDim.x)
        tile[t] = Num<T>::row(far, far, far);
      __syncthreads();
      if (warp_live) {
        for (int s0 = 0; s0 < padded; s0 += 32) {
          unsigned m = 0;
#pragma unroll
          for (int u = 0; u < 32; ++u) R.test(tile[s0 + u], cutoff2, u, m);
          Q.push(m, s0);
          // drain before a queue can overflow, and after the tile's last
          // block (the entries name its rows)
          if (__any_sync(FULL, Q.cnt == QUEUE) || s0 + 32 >= padded)
            Q.drain(1, 0, tile, R, law, gc);
        }
      }
      __syncthreads();  // the tile is consumed
    }
    if (r < rb) {
      out[r * C + c] = R.ax;
      out[oc + r * C + c] = R.ay;
      out[2 * oc + r * C + c] = R.az;
    }
  }
}

// Stages the supplier rows of the neighbour columns from neighbour nb's
// row `row` on into the warp's buffer, at most CAP rows; advances nb and
// row (warp-uniform) past what it staged.  Returns the rows staged.
template <typename T>
__device__ int stage(const Geometry<T>& G, int ci, int cj, int ck,
                     const signed char* table, int n_off, int& nb, int& row,
                     typename Num<T>::Row* q, int lane) {
  int total = 0;
  while (nb < n_off && total < CAP) {
    const int avail = min(32, n_off - nb);
    T hx = 0, hy = 0, hz = 0;
    int col = 0, cnt = 0;
    if (lane < avail) {
      col = neighbour(G, ci, cj, ck, table + 3 * (nb + lane), hx, hy, hz);
      cnt = G.sb ? min(G.sb[col], G.K_s) : G.K_s;
    }
    const int first = lane == 0 ? row : 0;
    cnt = max(cnt - first, 0);
    int incl = cnt;  // inclusive scan of the row counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const int room = CAP - total;
    // incl never falls with the lane, so the columns that fit are a prefix
    const int nfit = __popc(__ballot_sync(FULL, lane < avail && incl <= room));
    const int at = total + incl - cnt;
    // shallow columns: a lane per column (lanes on neighbouring columns
    // read neighbouring addresses); deep ones: the lanes over its rows
    const int deepest = __reduce_max_sync(FULL, lane < nfit ? cnt : 0);
    const int passes = __reduce_add_sync(FULL, lane < nfit ? (cnt + 31) / 32 : 0);
    if (deepest <= passes) {
      if (lane < nfit) {
#pragma unroll 4
        for (int s = 0; s < cnt; ++s) stage_row(G, first + s, col, hx, hy, hz, q, at + s);
      }
    } else {
      for (int j = 0; j < nfit; ++j) {
        const int jcnt = __shfl_sync(FULL, cnt, j);
        const int jcol = __shfl_sync(FULL, col, j);
        const int jfirst = __shfl_sync(FULL, first, j);
        const int jat = __shfl_sync(FULL, at, j);
        const T jhx = __shfl_sync(FULL, hx, j);
        const T jhy = __shfl_sync(FULL, hy, j);
        const T jhz = __shfl_sync(FULL, hz, j);
        for (int t = lane; t < jcnt; t += 32)
          stage_row(G, jfirst + t, jcol, jhx, jhy, jhz, q, jat + t);
      }
    }
    total += nfit ? __shfl_sync(FULL, incl, nfit - 1) : 0;
    if (nfit < avail) {
      // neighbour nb + nfit does not fit whole: stage the rows that do
      const int part = CAP - total;
      const int pcol = __shfl_sync(FULL, col, nfit);
      const T phx = __shfl_sync(FULL, hx, nfit);
      const T phy = __shfl_sync(FULL, hy, nfit);
      const T phz = __shfl_sync(FULL, hz, nfit);
      const int pfirst = nfit == 0 ? row : 0;
      for (int t = lane; t < part; t += 32)
        stage_row(G, pfirst + t, pcol, phx, phy, phz, q, total + t);
      nb += nfit;
      row = pfirst + part;
      total = CAP;
    } else {
      nb += nfit;
      row = 0;
    }
  }
  __syncwarp();
  return total;
}

// The reach table (117 columns of ~8 rows at the 4-mesh-cell layout): a
// warp per receiver column, WARPS columns a block, at least MIN_BLOCKS
// blocks resident on an SM (8 in float, 4 in double).
template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) pair_sweep_kernel_reach(
    const T* __restrict__ recv, long long recv_cs, int K_r, Geometry<T> G,
    const int* __restrict__ rbound, T* __restrict__ out, T cutoff2,
    ForceLaw<T> law, GCoef gc, Offsets offs) {
  __shared__ typename Num<T>::Row staged[WARPS][CAP];
  __shared__ unsigned qmask[QUEUE][WARPS * 32];
  __shared__ unsigned short qbase[QUEUE][WARPS * 32];
  __shared__ signed char table[3 * MAX_OFFSETS];
  const int n_off = offs.count;
  for (int i = threadIdx.x; i < 3 * n_off; i += blockDim.x) table[i] = offs.d[i];
  __syncthreads();  // the only block barrier

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = G.n;
  const long long C = G.C;
  const long long c = (long long)blockIdx.x * WARPS + w;
  if (c >= C) return;
  const long long oc = (long long)K_r * C;
  const int ci = (int)(c / ((long long)n * n)), cj = (int)((c / n) % n),
            ck = (int)(c % n);
  const int rb = rbound ? max(0, min(rbound[c], K_r)) : K_r;
  // rows at or beyond the bound write exactly 0
  for (int r = rb + lane; r < K_r; r += 32) {
    out[(long long)r * C + c] = T(0);
    out[oc + (long long)r * C + c] = T(0);
    out[2 * oc + (long long)r * C + c] = T(0);
  }
  typename Num<T>::Row* q = staged[w];
  Queue Q{&qmask[0][threadIdx.x], &qbase[0][threadIdx.x], WARPS * 32, 0};

  for (int r0 = 0; r0 < rb; r0 += 32) {
    // warp-uniform split of the lanes: R receivers × Gr supplier groups
    const int R = min(32, rb - r0);
    const int Gr = 32 / R;
    const int rho = lane % R, g = lane / R;
    const long long r = r0 + rho;
    Receiver<T> Rc(recv, recv_cs, r * C + c, g < Gr);
    int nb = 0, row = 0;
    while (nb < n_off) {
      const int total = stage(G, ci, cj, ck, table, n_off, nb, row, q, lane);
      for (int s0 = 0; s0 < total; s0 += 32 * Gr) {
        unsigned m = 0;
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const int s = s0 + u * Gr + g;
          if (s < total) Rc.test(q[s], cutoff2, u, m);
        }
        Q.push(m, s0);
        // drain before a queue can overflow, and after the staging's last
        // block (the entries name its rows)
        if (__any_sync(FULL, Q.cnt == QUEUE) || s0 + 32 * Gr >= total)
          Q.drain(Gr, g, q, Rc, law, gc);
      }
      __syncwarp();  // the staged rows are consumed before the next staging
    }
    // add the groups' sums into the lanes of group 0
    T ax = Rc.ax, ay = Rc.ay, az = Rc.az;
    for (int k = 1; k < Gr; ++k) {
      const int src = min(lane + k * R, 31);
      const T tx = __shfl_sync(FULL, ax, src);
      const T ty = __shfl_sync(FULL, ay, src);
      const T tz = __shfl_sync(FULL, az, src);
      if (lane < R) {
        ax += tx;
        ay += ty;
        az += tz;
      }
    }
    if (lane < R) {
      out[r * C + c] = ax;
      out[oc + r * C + c] = ay;
      out[2 * oc + r * C + c] = az;
    }
  }
}

// ---------------------------------------------------------------------- //
// The global sweeps (pair_sweep_global_kernel; rows 6 and 2): the ±1
// table over the bounded slot layouts of the global steppers, receivers =
// suppliers (row 6) or one set against another (row 2).  Their columns
// range from empty to several hundred rows deep, so a block per column
// (pair_sweep_kernel) idles on the shallow ones and leaves a deep one to
// run alone at the end.  Here the work is a list of items, built on the
// device by the wrapper (cuda_shortrange.global_work_list): an item is a
// receiver column and its first row, at most GW_ITEM rows, so a deep
// column makes several items and a column with no receiver none.  The
// list runs from the columns with the most items down, and within one
// count in column order, so that the warps at work at one time share
// their neighbourhoods' rows in L2 (a finer order by depth would scatter
// the neighbourhood reads over the box).  Persistent blocks (as many as
// fit on the SMs at once) of GW_WARPS warps, each warp taking items from
// one atomic counter: for an item of nr rows it holds R = ⌈nr/32⌉ ≤ GW_RMAX
// receivers a lane (one shared load serves R tests), stages the item's
// neighbourhood once, compacted by the supplier bounds and with the ±box
// wrap, GW_STAGE_BYTES at a time (stage_flat(): 512 rows in float, 256 in
// double), and queues and drains its pass masks as the kernels above do.
// Each receiver's sum stays in one lane and takes its pairs in the staged
// order of pair_sweep_kernel, by the same arithmetic, so the output equals
// that kernel's unbounded launch bit for bit.  Rows at or beyond a
// column's receiver bound are written 0 by the warps once the items run
// out.  PAIR_SWEEP_SPLIT (a build flag of scripts/torch_sweep_split.py,
// 0 as shipped) builds the variants that split its time: 1 tests the
// pairs but skips the force path, 2 only stages.
// GW_RMAX, GW_STAGE_BYTES and GW_BLOCKS_F32 take -D overrides for the
// same script's variants (GW_RMAX ≤ 4; the wrapper's GLOBAL_ITEM_ROWS
// must then match).
#define GW_WARPS 4               // global kernel: warps a block, each on its own items
#ifndef GW_RMAX
#define GW_RMAX 2                // global kernel: receivers a lane holds, at most
#endif
#ifndef GW_BLOCKS_F32
#define GW_BLOCKS_F32 5          // global kernel: resident blocks an SM, float
#endif
#define GW_ITEM (32 * GW_RMAX)   // global kernel: receiver rows an item holds, at most
#define GW_QUEUE 12              // global kernel: queue entries a lane holds
#ifndef GW_STAGE_BYTES
#define GW_STAGE_BYTES 8192      // global kernel: staged rows a warp holds, in bytes
#endif
#define GW_COL_SHIFT 24          // an item is column << GW_COL_SHIFT | chunk
#define GW_INFLIGHT 4            // global kernel: rows a lane stages at once
#ifndef PAIR_SWEEP_SPLIT
#define PAIR_SWEEP_SPLIT 0
#endif

template <typename T>
struct GlobalWork {
  const T* recv;
  long long recv_cs;
  int K_r;
  const int* rb;           // (C,) receiver bounds in [0, K_r]
  const long long* items;  // the work list
  const int* n_items;      // its length, on the device
  int* counter;            // the next item, 0 at the launch
  T* out;
  T cutoff2;
};

// Stages the supplier rows of the neighbour columns for the global
// kernel, from neighbour nb's row `row` on, at most Cap rows, in the order
// and places of stage(), and advances nb and row past what it staged.
// Where stage() copies a column a lane or a column at a time, each a
// chain of loads as long as the column is deep, this copies the rows of
// the neighbourhood as one flat range, GW_INFLIGHT rows a lane at once
// (a lane finds the column of its flat row by a binary search over the
// lanes' inclusive row counts), so that a staging waits on a few load
// latencies only.
template <typename T, int Cap>
__device__ int stage_flat(const Geometry<T>& G, int ci, int cj, int ck,
                          const signed char* table, int n_off, int& nb, int& row,
                          typename Num<T>::Row* q, int lane) {
  int total = 0;
  while (nb < n_off && total < Cap) {
    const int avail = min(32, n_off - nb);
    T hx = 0, hy = 0, hz = 0;
    int col = 0, cnt = 0;
    if (lane < avail) {
      col = neighbour(G, ci, cj, ck, table + 3 * (nb + lane), hx, hy, hz);
      cnt = G.sb ? min(G.sb[col], G.K_s) : G.K_s;
    }
    const int first = lane == 0 ? row : 0;
    cnt = max(cnt - first, 0);
    int incl = cnt;  // inclusive scan of the row counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - cnt;
    // the lane (column) of flat row t: the number of lanes with incl ≤ t
    auto column_of = [&](int t) {
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(FULL, incl, j + step - 1) <= t) j += step;
      return j;
    };
    const int all = __shfl_sync(FULL, incl, 31);
    const int take = min(all, Cap - total);
    for (int t0 = 0; t0 < take; t0 += 32 * GW_INFLIGHT) {
      T x[GW_INFLIGHT], y[GW_INFLIGHT], z[GW_INFLIGHT];
#pragma unroll
      for (int u = 0; u < GW_INFLIGHT; ++u) {
        const int t = t0 + 32 * u + lane;
        const int j = column_of(t);
        const int jcol = __shfl_sync(FULL, col, j);
        const int jrow = __shfl_sync(FULL, first - excl, j) + t;
        const T jhx = __shfl_sync(FULL, hx, j);
        const T jhy = __shfl_sync(FULL, hy, j);
        const T jhz = __shfl_sync(FULL, hz, j);
        if (t < take) {
          const long long a = (long long)jrow * G.C + jcol;
          x[u] = G.sup[a] + jhx;
          y[u] = G.sup[G.sup_cs + a] + jhy;
          z[u] = G.sup[2 * G.sup_cs + a] + jhz;
        }
      }
#pragma unroll
      for (int u = 0; u < GW_INFLIGHT; ++u) {
        const int t = t0 + 32 * u + lane;
        if (t < take) q[total + t] = Num<T>::row(x[u], y[u], z[u]);
      }
    }
    total += take;
    if (take == all) {
      nb += avail;
      row = 0;
    } else {
      // column j holds flat row `take`: the next staging starts there
      const int j = column_of(take);
      row = __shfl_sync(FULL, first - excl, j) + take;
      nb += j;
    }
  }
  __syncwarp();
  return total;
}

// One item: rows r0 .. r0 + nr − 1 of column c, R receivers a lane (rows
// r0 + lane + 32k), against the 27 neighbour columns' supplier rows.
template <typename T, int R, int Cap>
__device__ __forceinline__ void global_item(const GlobalWork<T>& W, const Geometry<T>& G,
                                            const ForceLaw<T>& law, const GCoef& gc,
                                            const signed char* table, long long c, int r0,
                                            int nr, typename Num<T>::Row* q, unsigned* qmask,
                                            unsigned short* qbase, int lane) {
  using Row = typename Num<T>::Row;
  const long long C = G.C;
  const int stride = GW_WARPS * 32;
  T ox[R], oy[R], oz[R], ax[R], ay[R], az[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    ox[k] = oy[k] = oz[k] = Num<T>::nan();
    ax[k] = ay[k] = az[k] = T(0);
    if (lane + 32 * k < nr) {
      const long long at = (long long)(r0 + lane + 32 * k) * C + c;
      ox[k] = W.recv[at];
      oy[k] = W.recv[W.recv_cs + at];
      oz[k] = W.recv[2 * W.recv_cs + at];
    }
  }
  const int n = G.n;
  const int ci = (int)(c / ((long long)n * n)), cj = (int)((c / n) % n), ck = (int)(c % n);
  const T far = T(1e30);  // pads a staging to whole 32-blocks
  int cnt = 0, nb = 0, row = 0;
  while (nb < 27) {
    const int total = stage_flat<T, Cap>(G, ci, cj, ck, table, 27, nb, row, q, lane);
    const int padded = (total + 31) & ~31;
    if (total + lane < padded) q[total + lane] = Num<T>::row(far, far, far);
    __syncwarp();
#if PAIR_SWEEP_SPLIT < 2
    for (int s0 = 0; s0 < padded; s0 += 32) {
      unsigned m[R];
#pragma unroll
      for (int k = 0; k < R; ++k) m[k] = 0;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const Row p = q[s0 + u];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const T r2 = dist2(ox[k] - p.x, oy[k] - p.y, oz[k] - p.z);
          if (r2 < W.cutoff2 && r2 > T(0)) m[k] |= 1u << u;
        }
      }
#if PAIR_SWEEP_SPLIT == 1
#pragma unroll
      for (int k = 0; k < R; ++k) ax[k] += T(__popc(m[k]));
#else
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (m[k]) {
          qmask[cnt * stride] = m[k];
          qbase[cnt * stride] = (unsigned short)(s0 | (k << 14));
          ++cnt;
        }
      }
      // drain before a queue can overflow, and after the staging's last
      // block (the entries name its rows): each lane walks its own passing
      // pairs, one an iteration, in the order they were tested
      if (__any_sync(FULL, cnt > GW_QUEUE - R) || s0 + 32 >= padded) {
        int e = 0, b0 = 0, kk = 0;
        unsigned mm = 0;
        while (true) {
          if (mm == 0) {
            if (e == cnt) break;
            mm = qmask[e * stride];
            const unsigned b = qbase[e * stride];
            b0 = b & 0x3fff;
            kk = b >> 14;
            ++e;
          }
          const Row p = q[b0 + __ffs(mm) - 1];
          T rx = ox[0], ry = oy[0], rz = oz[0];
#pragma unroll
          for (int k = 1; k < R; ++k) {
            if (kk == k) {
              rx = ox[k];
              ry = oy[k];
              rz = oz[k];
            }
          }
          const T dx = rx - p.x, dy = ry - p.y, dz = rz - p.z;
          const T f = pair_factor(dist2(dx, dy, dz), law, gc);
#pragma unroll
          for (int k = 0; k < R; ++k) {
            if (kk == k) {
              ax[k] += f * dx;
              ay[k] += f * dy;
              az[k] += f * dz;
            }
          }
          mm &= mm - 1;
        }
        cnt = 0;
      }
#endif
    }
#endif
    __syncwarp();  // the staged rows are consumed before the next staging
  }
  const long long oc = (long long)W.K_r * C;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (lane + 32 * k < nr) {
      const long long at = (long long)(r0 + lane + 32 * k) * C + c;
      W.out[at] = ax[k];
      W.out[oc + at] = ay[k];
      W.out[2 * oc + at] = az[k];
    }
  }
}

// global_item at R = r receivers a lane, r ≤ R (only R ≤ GW_RMAX is built)
template <typename T, int R, int Cap>
__device__ __forceinline__ void item_of_depth(int r, const GlobalWork<T>& W,
                                              const Geometry<T>& G, const ForceLaw<T>& law,
                                              const GCoef& gc, const signed char* table,
                                              long long c, int r0, int nr,
                                              typename Num<T>::Row* q, unsigned* qmask,
                                              unsigned short* qbase, int lane) {
  if constexpr (R > 1) {
    if (r < R) {
      item_of_depth<T, R - 1, Cap>(r, W, G, law, gc, table, c, r0, nr, q, qmask, qbase, lane);
      return;
    }
  }
  global_item<T, R, Cap>(W, G, law, gc, table, c, r0, nr, q, qmask, qbase, lane);
}

template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(GW_WARPS * 32, MIN_BLOCKS) pair_sweep_global_kernel(
    GlobalWork<T> W, Geometry<T> G, ForceLaw<T> law, GCoef gc) {
  constexpr int Cap = GW_STAGE_BYTES / (int)sizeof(typename Num<T>::Row);
  __shared__ typename Num<T>::Row staged[GW_WARPS][Cap];
  __shared__ unsigned qmask[GW_QUEUE][GW_WARPS * 32];
  __shared__ unsigned short qbase[GW_QUEUE][GW_WARPS * 32];
  __shared__ signed char table[81];
  // the 27 offsets (di, dj, dk) in pair_sweep_kernel's order: the
  // launches' table, cuda_shortrange.OFFSETS_27
  for (int i = threadIdx.x; i < 27; i += blockDim.x) {
    table[3 * i] = (signed char)(i / 9 - 1);
    table[3 * i + 1] = (signed char)((i / 3) % 3 - 1);
    table[3 * i + 2] = (signed char)(i % 3 - 1);
  }
  __syncthreads();  // the only block barrier

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n_items = *W.n_items;
  unsigned* qm = &qmask[0][threadIdx.x];
  unsigned short* qb = &qbase[0][threadIdx.x];
  while (true) {
    int it = 0;
    if (lane == 0) it = atomicAdd(W.counter, 1);
    it = __shfl_sync(FULL, it, 0);
    if (it >= n_items) break;
    const long long e = W.items[it];
    const long long c = e >> GW_COL_SHIFT;
    const int r0 = (int)(e & ((1 << GW_COL_SHIFT) - 1)) * GW_ITEM;
    const int nr = min(GW_ITEM, W.rb[c] - r0);
    item_of_depth<T, GW_RMAX, Cap>((nr + 31) >> 5, W, G, law, gc, table, c, r0, nr,
                                   staged[w], qm, qb, lane);
  }
  // no item left: rows at or beyond a column's receiver bound write 0, a
  // lane per column (neighbouring lanes on neighbouring addresses)
  const long long C = G.C, oc = (long long)W.K_r * C;
  const long long warps = (long long)gridDim.x * GW_WARPS;
  for (long long c = ((long long)blockIdx.x * GW_WARPS + w) * 32 + lane; c < C;
       c += warps * 32) {
    for (long long a = (long long)W.rb[c] * C + c; a < oc; a += C) {
      W.out[a] = T(0);
      W.out[oc + a] = T(0);
      W.out[2 * oc + a] = T(0);
    }
  }
}

// The launches' force law: GADGET-2 spline h = 2.8ε (soft2 = ε²).
template <typename T>
static ForceLaw<T> force_law(T inv_scale, T soft2, int kernel) {
  const T h = T(2.8) * std::sqrt(soft2);
  ForceLaw<T> law;
  law.kernel = kernel;
  law.inv_scale = inv_scale;
  law.inv_scale2 = inv_scale * inv_scale;
  law.h2 = T(7.84) * soft2;
  law.inv_h = h > T(0) ? T(1) / std::fmax(h, T(1e-30)) : T(1e30);
  law.soft2 = soft2;
  return law;
}

template <typename T>
static Geometry<T> geometry(const T* sup, long long sup_cs, int K_s, int n, int nx,
                            const int* sb, T boxsize) {
  Geometry<T> G;
  G.sup = sup;
  G.sup_cs = sup_cs;
  G.C = (long long)nx * n * n;
  G.K_s = K_s;
  G.n = n;
  G.nx = nx;
  G.sb = sb;
  G.boxsize = boxsize;
  return G;
}

static GCoef coefficients(const float* coef) {
  GCoef gc;
  for (int i = 0; i < NCOEF; ++i) gc.c[i] = coef ? coef[i] : 0.0f;
  return gc;
}

template <typename T, int MIN_BLOCKS>
static int launch_global(const T* recv, long long recv_cs, int K_r, const T* sup,
                         long long sup_cs, int K_s, int n, const int* rb, const int* sb,
                         const long long* items, const int* n_items, int* counter, T* out,
                         T boxsize, T inv_scale, T cutoff2, T soft2, int kernel,
                         const float* coef, void* stream) {
  const GlobalWork<T> W{recv, recv_cs, K_r, rb, items, n_items, counter, out, cutoff2};
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_sweep_global_kernel<T, MIN_BLOCKS>, GW_WARPS * 32, 0);
  const unsigned blocks = (unsigned)((per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1));
  pair_sweep_global_kernel<T, MIN_BLOCKS><<<blocks, GW_WARPS * 32, 0, (cudaStream_t)stream>>>(
      W, geometry(sup, sup_cs, K_s, n, n, sb, boxsize), force_law(inv_scale, soft2, kernel),
      coefficients(coef));
  return (int)cudaGetLastError();
}

template <typename T, int REACH_BLOCKS>
static int launch(const T* recv, long long recv_cs, int K_r, const T* sup, long long sup_cs,
                  int K_s, int n, int nx, const int* rb, const int* sb, T* out, T boxsize,
                  T inv_scale,
                  T cutoff2, T soft2, int kernel, const float* coef,
                  const signed char* offsets, int n_offsets, void* stream) {
  if (n_offsets < 1 || n_offsets > MAX_OFFSETS) return (int)cudaErrorInvalidValue;
  const GCoef gc = coefficients(coef);
  Offsets offs;
  offs.count = n_offsets;
  for (int i = 0; i < 3 * n_offsets; ++i) offs.d[i] = offsets[i];
  const ForceLaw<T> law = force_law(inv_scale, soft2, kernel);
  const Geometry<T> G = geometry(sup, sup_cs, K_s, n, nx, sb, boxsize);
  if (n_offsets <= 27) {
    const int rows = ((K_r + 31) / 32) * 32;
    const int threads = rows < THREADS ? rows : THREADS;
    pair_sweep_kernel<T><<<(unsigned)G.C, threads, 6 * QUEUE * threads,
                           (cudaStream_t)stream>>>(recv, recv_cs, K_r, G, rb, out,
                                                   cutoff2, law, gc, offs);
  } else {
    pair_sweep_kernel_reach<T, REACH_BLOCKS>
        <<<(unsigned)((G.C + WARPS - 1) / WARPS), WARPS * 32, 0, (cudaStream_t)stream>>>(
            recv, recv_cs, K_r, G, rb, out, cutoff2, law, gc, offs);
  }
  return (int)cudaGetLastError();
}

// recv (3, K_r, C) and sup (3, K_s, C) float32, C = nx·n² columns, rows
// contiguous with row stride C and component strides recv_cs / sup_cs;
// out (3, K_r, C) contiguous.  rb/sb: (C,) int32 device arrays of per-column row bounds,
// each may be null (no bound).  coef: host array of NCOEF floats;
// offsets: host array of n_offsets (di, dj, dk) triples, n_offsets ≤
// MAX_OFFSETS.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a table that does not fit).
extern "C" int pair_sweep_launch(const float* recv, long long recv_cs, int K_r,
                                 const float* sup, long long sup_cs, int K_s,
                                 int n, int nx, const int* rb, const int* sb,
                                 float* out, float boxsize, float inv_scale,
                                 float cutoff2, float soft2, int kernel,
                                 const float* coef, const signed char* offsets,
                                 int n_offsets, void* stream) {
  return launch<float, 8>(recv, recv_cs, K_r, sup, sup_cs, K_s, n, nx, rb, sb, out, boxsize,
                          inv_scale, cutoff2, soft2, kernel, coef, offsets, n_offsets, stream);
}

// The same in double: every array float64, the screening exact (no
// coefficients).
extern "C" int pair_sweep_launch_f64(const double* recv, long long recv_cs, int K_r,
                                     const double* sup, long long sup_cs, int K_s, int n,
                                     int nx, const int* rb, const int* sb, double* out,
                                     double boxsize, double inv_scale, double cutoff2,
                                     double soft2, int kernel, const signed char* offsets,
                                     int n_offsets, void* stream) {
  return launch<double, 4>(recv, recv_cs, K_r, sup, sup_cs, K_s, n, nx, rb, sb, out, boxsize,
                           inv_scale, cutoff2, soft2, kernel, nullptr, offsets, n_offsets,
                           stream);
}

// The global sweep (rows 6 and 2): recv, sup, out as for
// pair_sweep_launch at nx = n; rb (C,) int32 receiver bounds in [0, K_r]
// (required), sb (C,) supplier bounds or null; items the work list
// (column << 24 | chunk of GW_ITEM rows), n_items its length and counter
// an int32 set to 0, all on the device.
extern "C" int pair_sweep_global_launch(const float* recv, long long recv_cs, int K_r,
                                        const float* sup, long long sup_cs, int K_s, int n,
                                        const int* rb, const int* sb, const long long* items,
                                        const int* n_items, int* counter, float* out,
                                        float boxsize, float inv_scale, float cutoff2,
                                        float soft2, int kernel, const float* coef,
                                        void* stream) {
  return launch_global<float, GW_BLOCKS_F32>(recv, recv_cs, K_r, sup, sup_cs, K_s, n, rb, sb,
                                             items,
                                 n_items, counter, out, boxsize, inv_scale, cutoff2, soft2,
                                 kernel, coef, stream);
}

extern "C" int pair_sweep_global_launch_f64(const double* recv, long long recv_cs, int K_r,
                                            const double* sup, long long sup_cs, int K_s,
                                            int n, const int* rb, const int* sb,
                                            const long long* items, const int* n_items,
                                            int* counter, double* out, double boxsize,
                                            double inv_scale, double cutoff2, double soft2,
                                            int kernel, void* stream) {
  return launch_global<double, 4>(recv, recv_cs, K_r, sup, sup_cs, K_s, n, rb, sb, items,
                                  n_items, counter, out, boxsize, inv_scale, cutoff2, soft2,
                                  kernel, nullptr, stream);
}

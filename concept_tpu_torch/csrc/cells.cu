// CIC deposit and gather straight from a slot-major (K, C) column layout.
//
// Replaces concept_tpu/grid/pallas_cells.py
//   _deposit_kernel_cells (pallas_call at :284) and
//   _gather_kernel_cells  (pallas_call at :341),
// and concept_tpu/grid/pallas_pm.py
//   _deposit_kernel_pos   (pallas_call at :322) and
//   _gather_kernel_pos    (pallas_call at :379).
//
// Columns are cubes cb mesh cells wide, C = nc³ of them: the rung
// stepper's cells (cb = 8 or 4, ids x-major: c = (cx·nc + cy)·nc + cz) or
// the global and bucket steppers' PM blocks (cb = 2, ids z-major: c =
// (cz·nc + cy)·nc + cx); both are launch arguments.  The columns may also
// be a rank's nx planes of them from global plane x0 on (C = nx·nc², the
// rung stepper over ranks: its planes of cells, or on the tight layout the
// blocks' planes of its PM, ids (cz·nc + cy)·nx + cx − x0): the mesh is
// then the planes' rows with one halo row a side, nx·cb + 2 rows along x
// from global mesh row x0·cb − 1, not wrapped along x (a slot's anchor
// row is its column's local plane·cb + its offset in the column's halo, 0
// to cb), and the caller moves these rows onto the ranks' FFT slabs
// (deposit) or fills them from there (gather).  A slot takes part
// only when its CIC cloud lies inside its column's ±1-mesh-cell halo, the
// test of _cell_geometry (pallas_cells.py:133) and _slot_geometry
// (pallas_pm.py:182): the TPU kernels fill a (cb+2)³ mini-grid per column
// and drop the rest, so the deposited mass falls short exactly when a
// particle drifted out of its column's halo, which the steppers check
// (mass_sum).  Unlike the TPU kernels, the test here is periodic: a
// particle that crossed a box face is wrapped to the far side of the box
// but still lies in its column's halo, and is kept.  (The global stepper
// rebuilds its blocks from wrapped positions at every kick, so there both
// tests keep the same slots.)
//
// What bounds them on the card: device memory.  A slot's weight w is read
// whether or not the slot holds a particle; a live slot moves 12 bytes of
// position more and makes 8 corner updates (deposit) or 8·D corner reads
// and D floats out (gather; every slot writes its D outputs), for ~30
// FP32 operations.
//
// Design (the deposit for every layout, the gather on the blocks).  The
// first design ran a thread per slot: 7/8 of the threads found w = 0, and
// each live slot made 8 scattered global atomics (deposit) or 8·D
// scattered mesh reads (gather).  Now a CTA takes a tile of columns and a
// chunk of its rows.  Tiles (chosen among the shapes measured): cb 8 1 × 1
// × 8 columns, cb 4 2 × 2 × 8, the blocks 8 × 4 × 8 (z, y, x); each
// thread keeps one column and SLOTS = 8 rows of it, so a chunk is 512, 64
// or 8 rows and a deep column spreads over several CTAs.  A thread first
// reads its slots' w, coalesced along the row; a chunk with no live slot
// exits at once (the gather writes its zeros).  Any slot inside its own
// column's halo lies inside the tile's halo, (tile + 2)³ mesh cells, which
// lives in shared memory:
//   deposit: the live slots add their 8 corner weights (wx·wy·wz)·q, in
//     the plain version's order, to the zeroed halo tile with shared
//     atomics; the tile then goes to the zeroed mesh by one global atomic
//     a nonzero cell, in runs along z: on the cells by 4-float vector
//     atomics (halo rows padded to 16-byte alignment), on the blocks cell
//     by cell (the padding's strides put the blocks' neighbouring threads,
//     which lie along x, on a few shared-memory banks);
//   gather (the blocks): the halo of all D fields is staged by
//     asynchronous copies (cp.async), the periodic wrap taken there, while
//     the threads read their live slots' positions and compute their
//     anchors; each slot then reads its 8·D corners from shared memory
//     and writes D values at (d, r, c), along the row as the slots were
//     read: one launch for the three gradient components.
// A per-column extent ext (C,) int32 may cut each column's rows: rows
// r ≥ ext[c] count as w = 0 (optional; the block P³M path passes its
// block counts, the rung stepper its occupancy extents to the cells'
// gather, which spares reading the empty rows' w).  The last tiles
// along a dimension are clipped to the mesh; a mesh smaller than a tile
// is one clipped tile along that dimension, whose halo wraps onto itself
// (its halo cells map to global cells with the wrap, and atomics add the
// copies).  Atomics add in no fixed order.
//
// The cells' gather (cb 8 and 4, PERF.md row 4) reads its corners from
// the mesh, through L1 and L2, in column slabs (gather_columns_kernel).
// The first design's thread per slot, neighbouring threads on
// neighbouring columns, swept every column of a row before the next row:
// with the mesh above L2 (grid ≥ 512) a live slot fetched its ~4 sectors
// a field anew, and the mesh reads were 75-91 % of its time (w and the
// positions alone: 0.65 of 3.49 ms at 384³ / grid 768, D = 1).  A warp
// now takes 32 slots of two neighbouring columns, which share their
// halos' sectors: 2.2-3.4× faster at grid 512-768, 16-20 % faster at the
// 128³ / grid 256 check, 60-82 % of the bytes bound at grid ≥ 512.
// Staging each column's halo in shared memory and the tiled gather
// (gather_tile_kernel on the cells' tiles) were slower everywhere (they
// fetch the whole halo for ~64 slots, or fewer).
// Measured beside the alternatives: PERF.md §6,
// scripts/cells_variants.py --row4.
//
// Every kernel is a template on the scalar type, instantiated for float
// and double (the _f64 launch functions).  The double kernels keep the
// float tiles: their shared halos take twice the bytes (the largest, the
// blocks' gather at D = 3, 82 KB of the 227 KB; the cells' gather's slab
// 4 × 16 × 34 doubles, 17 KB), the round-to-nearest
// intrinsics are the double ones (__dmul_rn, __dadd_rn, __dsub_rn), so a
// slot on a cell edge takes the plain version's cell, and a halo flushes
// by a scalar atomicAdd(double*) a nonzero cell, as there are no vector
// atomics of doubles; cp.async moves a double quad as two 16-byte copies.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

constexpr int kThreads = 256;

// The scalar type's round-to-nearest arithmetic (unfused) and floor.
template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float floor(float a) { return floorf(a); }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double floor(double a) { return ::floor(a); }
};

// The dynamic shared memory as the scalar type's halo (one name a type).
__device__ __forceinline__ float* shared_halo(float*) {
  extern __shared__ float halo_f[];
  return halo_f;
}
__device__ __forceinline__ double* shared_halo(double*) {
  extern __shared__ double halo_d[];
  return halo_d;
}

// Flush four halo cells (a 16-byte aligned row piece) to the mesh: one
// vector atomic in float, a scalar atomic a nonzero cell in double.
__device__ __forceinline__ void flush_quad(float* grid, const float* halo) {
  const float4 v = *reinterpret_cast<const float4*>(halo);
  if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(grid), v);
}
__device__ __forceinline__ void flush_quad(double* grid, const double* halo) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (halo[i] != 0.0) atomicAdd(grid + i, halo[i]);
}

// Asynchronous copies of one cell and of four (16 bytes at a time).
template <typename T>
__device__ __forceinline__ void copy_cell(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}
template <typename T>
__device__ __forceinline__ void copy_quad(T* dst, const T* src) {
  constexpr int kStep = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < 4; i += kStep) __pipeline_memcpy_async(dst + i, src + i, 16);
}

template <typename T>
struct Geometry {
  int ix, iy, iz;  // anchor mesh indices (unwrapped, ≥ −1)
  int lx;          // the anchor's offset along x in the column's halo
  T fx, fy, fz;
  bool in_halo;
};

// Column c of a grid whose x planes start at global plane x0 (x-major ids;
// x0 = 0 with z-major ids).
template <typename T>
__device__ __forceinline__ Geometry<T> cell_geometry(T px, T py, T pz, int c, int nc, int cb,
                                                     bool zmajor, T inv_h, int x0 = 0) {
  // round-to-nearest intrinsics keep u = p·inv_h − ½ unfused, as the
  // reference and the plain version form it, so the halo test agrees
  using N = Num<T>;
  const int fast = c % nc, cy = (c / nc) % nc, slow = c / (nc * nc);
  const int cx = (zmajor ? fast : slow) + x0, cz = zmajor ? slow : fast;
  Geometry<T> g;
  const T ux = N::add(N::mul(px, inv_h), T(-0.5));
  const T uy = N::add(N::mul(py, inv_h), T(-0.5));
  const T uz = N::add(N::mul(pz, inv_h), T(-0.5));
  const T ax = N::floor(ux), ay = N::floor(uy), az = N::floor(uz);
  g.fx = N::sub(ux, ax);
  g.fy = N::sub(uy, ay);
  g.fz = N::sub(uz, az);
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
  g.lx = lx;
  g.in_halo = lx <= cb && ly <= cb && lz <= cb;
  return g;
}

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

// A CTA's tile of TS × TM × TF columns along the id's slow, middle and
// fast axes (x, y, z for x-major ids; z, y, x for z-major), and the
// column this thread keeps.  The halo tile is indexed along the mesh's
// x, y, z, z fastest.
template <int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF>
struct SlotTile {
  static constexpr int kCols = TS * TM * TF;
  static constexpr int kRowStep = kThreads / kCols;  // rows one pass of the CTA covers
  static constexpr int TX = ZMAJOR ? TF : TS, TZ = ZMAJOR ? TS : TF;
  static constexpr int HX = TX * CB + 2, HY = TM * CB + 2, HZ = TZ * CB + 2;
  // A halo row along z is HZP floats.  With QUADS its cell hz lies at
  // hz + 3 of a row padded to a multiple of 4, so that its interior (hz in
  // [1, HZ − 1)) starts 16-byte aligned, as the mesh row's part it maps to
  // does: the rows move as 4-float quads and a scalar at each end.  That
  // makes every stride a multiple of 4 floats, which suits the cells
  // (neighbouring threads on neighbouring columns along z) but puts the
  // blocks' neighbours along x on few banks: there rows are cell by cell,
  // of odd length.
  static constexpr int HZP = QUADS ? (HZ + 3 + 3) / 4 * 4 : (HZ | 1);
  static constexpr int kLead = QUADS ? 3 : 0, kQuads = TZ * CB / 4;
  static constexpr int kItems = QUADS ? kQuads + 2 : HZ;  // runs a row
  static constexpr int kCells = HX * HY * HZP;
  static_assert(kCols <= kThreads && kThreads % kCols == 0,
                "a tile's columns divide the CTA's threads");
  static_assert(!QUADS || TZ * CB % 4 == 0, "a tile's rows along z hold whole quads");

  int nc, nx, x0, n;  // nx planes of columns along x from global plane x0
  bool slab;          // the mesh: the planes' slab + a halo row a side
  int cx0, cy0, cz0;  // the tile's first column along x (local), y, z
  int ex, ey, ez;     // its extent inside the grid, in columns
  int lcx, lcy, lcz;  // this thread's column in the tile
  int row;            // this thread's first row in a chunk
  bool inside;        // its column lies inside the grid
  long long c;        // its column id

  // the columns along the id's slow and fast axes (x is the slow axis of
  // x-major ids and the fast axis of z-major ones)
  static int count(int nc, int nx) {
    const int ns = ZMAJOR ? nc : nx, nf = ZMAJOR ? nx : nc;
    return ((ns + TS - 1) / TS) * ((nc + TM - 1) / TM) * ((nf + TF - 1) / TF);
  }

  // blockIdx.x's tile, fast axis fastest
  __device__ SlotTile(int nc_, int nx_, int x0_, bool slab_)
      : nc(nc_), nx(nx_), x0(x0_), n(nc_ * CB), slab(slab_) {
    const int NS = ZMAJOR ? nc : nx, NF = ZMAJOR ? nx : nc;
    const int nf = (NF + TF - 1) / TF, nm = (nc + TM - 1) / TM;
    const int t = blockIdx.x;
    const int f0 = (t % nf) * TF, m0 = ((t / nf) % nm) * TM, s0 = (t / (nf * nm)) * TS;
    const int k = threadIdx.x % kCols;
    const int tf = k % TF, tm = (k / TF) % TM, ts = k / (TF * TM);
    row = threadIdx.x / kCols;
    inside = s0 + ts < NS && m0 + tm < nc && f0 + tf < NF;
    c = ((long long)(s0 + ts) * nc + m0 + tm) * NF + f0 + tf;
    cx0 = ZMAJOR ? f0 : s0;
    cy0 = m0;
    cz0 = ZMAJOR ? s0 : f0;
    ex = min(TX, nx - cx0);
    ey = min(TM, nc - cy0);
    ez = min(TZ, nc - cz0);
    lcx = ZMAJOR ? tf : ts;
    lcy = tm;
    lcz = ZMAJOR ? ts : tf;
  }

  // The halo-tile index of the CIC anchor of a slot of this thread's
  // column at (px, py, pz), its fractions in f; −1 if the anchor leaves
  // the column's halo.  The arithmetic is cell_geometry's.
  template <typename T>
  __device__ __forceinline__ int anchor(T px, T py, T pz, T inv_h, T f[3]) const {
    using N = Num<T>;
    const T ux = N::add(N::mul(px, inv_h), T(-0.5));
    const T uy = N::add(N::mul(py, inv_h), T(-0.5));
    const T uz = N::add(N::mul(pz, inv_h), T(-0.5));
    const T ax = N::floor(ux), ay = N::floor(uy), az = N::floor(uz);
    f[0] = N::sub(ux, ax);
    f[1] = N::sub(uy, ay);
    f[2] = N::sub(uz, az);
    const int lx = ((int)ax - (x0 + cx0 + lcx) * CB + 1 + n) % n;
    const int ly = ((int)ay - (cy0 + lcy) * CB + 1 + n) % n;
    const int lz = ((int)az - (cz0 + lcz) * CB + 1 + n) % n;
    // unsigned: a negative remainder (a position far outside the box) is
    // outside the halo, as the plain version's remainder finds it
    if ((unsigned)lx > CB || (unsigned)ly > CB || (unsigned)lz > CB) return -1;
    return index(lcx * CB + lx, lcy * CB + ly, lcz * CB + lz);
  }

  static __device__ __forceinline__ int index(int hx, int hy, int hz) {
    return (hx * HY + hy) * HZP + hz + kLead;
  }
  // the offset of a CIC corner (0 or 1 along each axis) from its anchor
  static __device__ __forceinline__ int corner(int cx, int cy, int cz) {
    return (cx * HY + cy) * HZP + cz;
  }

  // Call quad(s, g) or scalar(s, g) on every run of the clipped tile's
  // halo: s its first shared index, g its first mesh index (the periodic
  // wrap taken; along x none on a slab mesh, whose row 0 is the halo row
  // below the first plane).  With QUADS the interior of a row along z goes
  // by aligned quads when ``vec`` (the mesh rows are 16-byte aligned:
  // n % 4 = 0); the rest cell by cell.
  template <class Scalar, class Quad>
  __device__ __forceinline__ void for_halo(bool vec, Scalar scalar, Quad quad) const {
    const int zend = ez * CB + 1;  // the clipped halo's last cell along z
    for (int it = threadIdx.x; it < HX * HY * kItems; it += kThreads) {
      const int k = it % kItems, hy = (it / kItems) % HY, hx = it / (kItems * HY);
      if (hx > ex * CB + 1 || hy > ey * CB + 1) continue;
      const int gx = slab ? cx0 * CB + hx : wrap(cx0 * CB - 1 + hx, n);
      const long long row = ((long long)gx * n + wrap(cy0 * CB - 1 + hy, n)) * n;
      int lo = k, hi = k + 1;
      if (QUADS) {
        lo = k == 0 ? 0 : (k <= kQuads ? 4 * k - 3 : HZ - 1);
        hi = k == 0 ? 1 : (k <= kQuads ? lo + 4 : HZ);
        if (vec && k >= 1 && k <= kQuads && hi <= zend) {
          quad(index(hx, hy, lo), row + cz0 * CB - 1 + lo);
          continue;
        }
      }
      for (int hz = lo; hz < hi && hz <= zend; ++hz)
        scalar(index(hx, hy, hz), row + wrap(cz0 * CB - 1 + hz, n));
    }
  }

  // Read this thread's SLOTS weights of chunk blockIdx.y (0 past the
  // column's rows or its extent); returns the row bound of its column.
  template <int SLOTS, typename T>
  __device__ __forceinline__ int weights(const T* __restrict__ w, int K,
                                         const int* __restrict__ ext, T q[SLOTS]) const {
    const int kend = !inside ? 0 : (ext ? min(K, ext[c]) : K);
    const long long C = (long long)nx * nc * nc;
    const int r0 = blockIdx.y * (SLOTS * kRowStep) + row;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int r = r0 + s * kRowStep;
      q[s] = r < kend ? w[r * C + c] : T(0);
    }
    return inside ? K : 0;
  }
};

template <typename T, int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS>
__global__ void __launch_bounds__(kThreads)
deposit_tile_kernel(const T* __restrict__ px, const T* __restrict__ py,
                    const T* __restrict__ pz, const T* __restrict__ w, int K, int nc,
                    int nx, int x0, bool slab, T inv_h, const int* __restrict__ ext,
                    bool vec, T* __restrict__ grid) {
  using Tile = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  T* halo = shared_halo(static_cast<T*>(nullptr));  // kCells
  const Tile tile(nc, nx, x0, slab);
  T q[SLOTS];
  tile.template weights<SLOTS>(w, K, ext, q);
  bool live = false;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) live |= q[s] != T(0);
  if (!__syncthreads_or(live)) return;
  for (int s = threadIdx.x; s < Tile::kCells; s += kThreads) halo[s] = T(0);
  __syncthreads();
  const long long C = (long long)nx * nc * nc;
  const int r0 = blockIdx.y * (SLOTS * Tile::kRowStep) + tile.row;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (q[s] == T(0)) continue;
    const long long i = (r0 + s * Tile::kRowStep) * C + tile.c;
    T f[3];
    const int a = tile.anchor(px[i], py[i], pz[i], inv_h, f);
    if (a < 0) continue;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const T wx = cx ? f[0] : T(1) - f[0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const T wy = cy ? f[1] : T(1) - f[1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const T wz = cz ? f[2] : T(1) - f[2];
          atomicAdd(halo + a + Tile::corner(cx, cy, cz), (wx * wy * wz) * q[s]);
        }
      }
    }
  }
  __syncthreads();
  tile.for_halo(
      vec,
      [&](int s, long long g) {
        if (halo[s] != T(0)) atomicAdd(grid + g, halo[s]);
      },
      [&](int s, long long g) { flush_quad(grid + g, halo + s); });
}

template <typename T, int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS>
__global__ void __launch_bounds__(kThreads)
gather_tile_kernel(const T* __restrict__ px, const T* __restrict__ py,
                   const T* __restrict__ pz, const T* __restrict__ w, int K, int nc,
                   int nx, int x0, bool slab, T inv_h, const int* __restrict__ ext,
                   bool vec, const T* __restrict__ grids, int D, T* __restrict__ out) {
  using Tile = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  T* halo = shared_halo(static_cast<T*>(nullptr));  // D × kCells
  const Tile tile(nc, nx, x0, slab);
  T q[SLOTS];
  const int kout = tile.template weights<SLOTS>(w, K, ext, q);  // rows written
  bool live = false;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) live |= q[s] != T(0);
  const long long C = (long long)nx * nc * nc, KC = K * C;
  const int r0 = blockIdx.y * (SLOTS * Tile::kRowStep) + tile.row;
  if (!__syncthreads_or(live)) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int r = r0 + s * Tile::kRowStep;
      if (r >= kout) continue;
      for (int d = 0; d < D; ++d) out[d * KC + r * C + tile.c] = T(0);
    }
    return;
  }
  const int n = nc * CB;
  const long long n3 = (long long)(slab ? nx * CB + 2 : n) * n * n;  // a field's mesh
  // asynchronous copies (cp.async): every load of the halo in flight at
  // once, none through registers
  tile.for_halo(
      vec,
      [&](int s, long long g) {
        for (int d = 0; d < D; ++d) copy_cell(halo + d * Tile::kCells + s, grids + d * n3 + g);
      },
      [&](int s, long long g) {
        for (int d = 0; d < D; ++d) copy_quad(halo + d * Tile::kCells + s, grids + d * n3 + g);
      });
  __pipeline_commit();
  // the live slots' anchors and fractions while the halo lands
  int a[SLOTS];
  T f[SLOTS][3];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    a[s] = -1;
    if (q[s] == T(0)) continue;
    const long long i = (r0 + s * Tile::kRowStep) * C + tile.c;
    a[s] = tile.anchor(px[i], py[i], pz[i], inv_h, f[s]);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int r = r0 + s * Tile::kRowStep;
    if (r >= kout) continue;
    const long long i = r * C + tile.c;
    if (a[s] < 0) {
      for (int d = 0; d < D; ++d) out[d * KC + i] = T(0);
      continue;
    }
    // the 8 corners' halo offsets and weights, shared by the D fields
    int off[8];
    T wt[8];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const T wx = cx ? f[s][0] : T(1) - f[s][0];
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const T wy = cy ? f[s][1] : T(1) - f[s][1];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz) {
          const T wz = cz ? f[s][2] : T(1) - f[s][2];
          const int k = (cx * 2 + cy) * 2 + cz;
          off[k] = a[s] + Tile::corner(cx, cy, cz);
          wt[k] = (wx * wy * wz) * q[s];
        }
      }
    }
    for (int d = 0; d < D; ++d) {
      const T* S = halo + d * Tile::kCells;
      T v = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += wt[k] * S[off[k]];
      out[d * KC + i] = v;
    }
  }
}

// The cells' gather (row 4, cb 8 and 4 with x-major ids).  A CTA takes
// kGroup = 32 consecutive column ids and a chunk of ROWS rows: a slab
// (ROWS = 16 as built; 8 and 32 were slower on most states measured).
// Its threads first read the slab's w, coalesced along the row
// (neighbouring threads on neighbouring columns), and the positions of
// its live slots, into shared memory; rows r ≥ ext[c] read nothing and
// count as w = 0.  Then each warp walks its share of the slab 32 slots a
// pass, 32 / ROWS neighbouring columns with the lanes down their rows, so
// that one load instruction's corners fall in those columns' (cb + 2)³
// halos and share their sectors.  The D ≤ 3 results replace the
// positions in shared memory and go out coalesced along the row.  Chunks
// run next to each other in blockIdx.x, so that a deep column's chunks
// read its halo from L2 close in time.  A slab with no live slot writes
// its zeros.
constexpr int kGroup = 32;
constexpr int kWarps = kThreads / 32;

template <int ROWS>
struct ColumnSlab {
  // a slab row's pitch: the lanes of a warp's pass hit distinct banks
  static constexpr int kPitch = kGroup + kGroup / ROWS;
  static constexpr int kSize = ROWS * kPitch;
  static_assert(32 % ROWS == 0 && ROWS % kWarps == 0, "a pass holds whole columns");
  // w, then px, py, pz (after the gather: the D outputs)
  template <typename T>
  static constexpr size_t bytes() { return 4 * kSize * sizeof(T); }
};

template <typename T, int CB, int ROWS>
__global__ void __launch_bounds__(kThreads)
gather_columns_kernel(const T* __restrict__ px, const T* __restrict__ py,
                      const T* __restrict__ pz, const T* __restrict__ w, int K, int nc,
                      int nx, int x0, bool slab, T inv_h, const int* __restrict__ ext,
                      const T* __restrict__ grids, int D, T* __restrict__ out) {
  using Slab = ColumnSlab<ROWS>;
  constexpr int P = Slab::kPitch, S = Slab::kSize;
  T* sw = shared_halo(static_cast<T*>(nullptr));  // 4 × S
  const int C = nx * nc * nc;
  const int chunks = (K + ROWS - 1) / ROWS;
  const int r0 = (blockIdx.x % chunks) * ROWS;
  const int c0 = (blockIdx.x / chunks) * kGroup;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = c0 + lane;  // this lane's column while reading and writing
  const int kend = c < C ? (ext ? min(K, ext[c]) : K) : 0;
  bool live = false;
  for (int j = warp; j < ROWS; j += kWarps) {
    const int r = r0 + j;
    const long long i = (long long)r * C + c;
    const T q = r < kend ? w[i] : T(0);
    sw[j * P + lane] = q;
    if (q != T(0)) {
      sw[S + j * P + lane] = px[i];
      sw[2 * S + j * P + lane] = py[i];
      sw[3 * S + j * P + lane] = pz[i];
      live = true;
    }
  }
  if (__syncthreads_or(live)) {
    const int n = nc * CB;
    const long long n3 = (long long)(slab ? nx * CB + 2 : n) * n * n;
    for (int it = warp; it < ROWS; it += kWarps) {  // 32 slots a pass
      const int col = it * (32 / ROWS) + lane / ROWS, k = (lane % ROWS) * P + col;
      const T q = sw[k];
      if (q == T(0)) continue;
      const Geometry<T> g = cell_geometry(sw[S + k], sw[2 * S + k], sw[3 * S + k], c0 + col,
                                          nc, CB, false, inv_h, x0);
      // a slab mesh's rows: the column's local plane·cb + the halo offset
      const int sx = (c0 + col) / (nc * nc) * CB + g.lx;
      if (!g.in_halo) {
        sw[k] = T(0);
        continue;
      }
      long long off[8];
      T wt[8];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const T wx = a ? g.fx : T(1) - g.fx;
        const long long ox = (long long)(slab ? sx + a : wrap(g.ix + a, n)) * n;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const T wy = b ? g.fy : T(1) - g.fy;
          const long long oy = (ox + wrap(g.iy + b, n)) * n;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const T wz = e ? g.fz : T(1) - g.fz;
            off[(a * 2 + b) * 2 + e] = oy + wrap(g.iz + e, n);
            wt[(a * 2 + b) * 2 + e] = (wx * wy * wz) * q;
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (d >= D) break;
        const T* G = grids + d * n3;
        T v = 0;
#pragma unroll
        for (int m = 0; m < 8; ++m) v += wt[m] * G[off[m]];
        sw[(1 + d) * S + k] = v;
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
          sw[j * P + lane] != T(0) ? sw[(1 + d) * S + j * P + lane] : T(0);
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

template <typename T, int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS>
static int deposit_tiles(const T* px, const T* py, const T* pz, const T* w, int K, int nc,
                         int nx, int x0, bool slab, T inv_h, const int* ext, T* grid,
                         cudaStream_t stream) {
  using Tile = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  if (K <= 0 || nc <= 0) return 0;
  const size_t bytes = sizeof(T) * Tile::kCells;
  auto kernel = deposit_tile_kernel<T, CB, ZMAJOR, QUADS, TS, TM, TF, SLOTS>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  const int rows = SLOTS * Tile::kRowStep;
  const dim3 grid_dims(Tile::count(nc, nx), (K + rows - 1) / rows);
  kernel<<<grid_dims, kThreads, bytes, stream>>>(px, py, pz, w, K, nc, nx, x0, slab, inv_h,
                                                 ext, nc * CB % 4 == 0, grid);
  return (int)cudaGetLastError();
}

template <typename T, int CB, bool ZMAJOR, bool QUADS, int TS, int TM, int TF, int SLOTS>
static int gather_tiles(const T* px, const T* py, const T* pz, const T* w, int K, int nc,
                        int nx, int x0, bool slab, T inv_h, const int* ext, const T* grids,
                        int D, T* out, cudaStream_t stream) {
  using Tile = SlotTile<CB, ZMAJOR, QUADS, TS, TM, TF>;
  if (K <= 0 || nc <= 0) return 0;
  const size_t bytes = sizeof(T) * D * Tile::kCells;
  auto kernel = gather_tile_kernel<T, CB, ZMAJOR, QUADS, TS, TM, TF, SLOTS>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  const int rows = SLOTS * Tile::kRowStep;
  const dim3 grid_dims(Tile::count(nc, nx), (K + rows - 1) / rows);
  kernel<<<grid_dims, kThreads, bytes, stream>>>(px, py, pz, w, K, nc, nx, x0, slab, inv_h,
                                                 ext, nc * CB % 4 == 0, grids, D, out);
  return (int)cudaGetLastError();
}

// The cells' gather: one launch for every 3 fields (the slab holds 3).
template <typename T, int CB, int ROWS>
static int gather_columns(const T* px, const T* py, const T* pz, const T* w, int K, int nc,
                          int nx, int x0, bool slab, T inv_h, const int* ext, const T* grids,
                          int D, T* out, cudaStream_t stream) {
  if (K <= 0 || nc <= 0) return 0;
  const size_t bytes = ColumnSlab<ROWS>::template bytes<T>();
  auto kernel = gather_columns_kernel<T, CB, ROWS>;
  static size_t allowed = 0;
  if (int err = shared_bytes(kernel, bytes, allowed)) return err;
  const long long C = (long long)nx * nc * nc, n = (long long)nc * CB;
  const long long mesh = (slab ? nx * CB + 2 : n) * n * n;
  const long long blocks = (C + kGroup - 1) / kGroup * ((K + ROWS - 1) / ROWS);
  for (int d0 = 0; d0 < D; d0 += 3) {
    kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
        px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext, grids + d0 * mesh, min(3, D - d0),
        out + d0 * K * C);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return 0;
}

// The tiles, chosen by scripts/cells_variants.py (PERF.md §6): cb 8 1 × 1
// × 8 columns (8 × 8 × 64 mesh cells) and cb 4 2 × 2 × 8 (8 × 8 × 32),
// rows by quads; the blocks 8 × 4 × 8 (16 × 8 × 16), cell by cell.  8
// slots a thread.  The same tiles in double.
#define CELLS8_TILE 8, false, true, 1, 1, 8, 8
#define CELLS4_TILE 4, false, true, 2, 2, 8, 8
#define BLOCKS_TILE 2, true, false, 8, 4, 8, 8
// The cells' gather: slabs of 16 rows (32 columns).
constexpr int kSlabRows = 16;

// The whole periodic mesh (slab 0: nx = nc, x0 = 0), or a rank's planes
// on their slab mesh (slab 1: planes of cells, x-major, or of blocks,
// z-major, whose ids then take nx along x: c = (cz·nc + cy)·nx + cx − x0).
static bool planes_ok(int nc, int cb, int zmajor, int nx, int x0, int slab) {
  if (!slab) return nx == nc && x0 == 0;
  return nx >= 1 && x0 >= 0 && x0 + nx <= nc;
}

template <typename T>
static int deposit(const T* px, const T* py, const T* pz, const T* w, int K, int nc, int cb,
                   int zmajor, int nx, int x0, int slab, T inv_h, const int* ext, T* grid,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!planes_ok(nc, cb, zmajor, nx, x0, slab)) return (int)cudaErrorInvalidValue;
  if (cb == 8 && !zmajor)
    return deposit_tiles<T, CELLS8_TILE>(px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext, grid,
                                         s);
  if (cb == 4 && !zmajor)
    return deposit_tiles<T, CELLS4_TILE>(px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext, grid,
                                         s);
  if (cb == 2 && zmajor)
    return deposit_tiles<T, BLOCKS_TILE>(px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext, grid,
                                         s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int gather(const T* px, const T* py, const T* pz, const T* w, int K, int nc, int cb,
                  int zmajor, int nx, int x0, int slab, T inv_h, const int* ext,
                  const T* grids, int D, T* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!planes_ok(nc, cb, zmajor, nx, x0, slab)) return (int)cudaErrorInvalidValue;
  if (cb == 2 && zmajor)
    return gather_tiles<T, BLOCKS_TILE>(px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext, grids,
                                        D, out, s);
  if (cb == 8 && !zmajor)
    return gather_columns<T, 8, kSlabRows>(px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext,
                                           grids, D, out, s);
  if (cb == 4 && !zmajor)
    return gather_columns<T, 4, kSlabRows>(px, py, pz, w, K, nc, nx, x0, slab, inv_h, ext,
                                           grids, D, out, s);
  return (int)cudaErrorInvalidValue;
}

// px, py, pz, w: (K, C) float32 with rows contiguous (row stride C), C =
// nx·nc²; ext: (C,) int32 row extents or null; grid contiguous, zeroed by
// the caller: (n, n, n) with slab 0 (nx = nc, x0 = 0), (nx·cb + 2, n, n)
// with slab 1.  Columns: cb 8 or 4 with x-major ids (zmajor 0), or cb 2
// with z-major ids (zmajor 1).  Returns the cudaError_t of the launch.
extern "C" int cic_deposit_launch(const float* px, const float* py, const float* pz,
                                  const float* w, int K, int nc, int cb, int zmajor, int nx,
                                  int x0, int slab, float inv_h, const int* ext, float* grid,
                                  void* stream) {
  return deposit<float>(px, py, pz, w, K, nc, cb, zmajor, nx, x0, slab, inv_h, ext, grid,
                        stream);
}

// grids (D, mesh) contiguous, mesh as the deposit's; out (D, K, C)
// contiguous, every entry written.  The blocks (cb 2, z-major) take the
// tiled kernel, the cells (cb 8 or 4, x-major) the column slabs; both take
// extents.
extern "C" int cic_gather_launch(const float* px, const float* py, const float* pz,
                                 const float* w, int K, int nc, int cb, int zmajor, int nx,
                                 int x0, int slab, float inv_h, const int* ext,
                                 const float* grids, int D, float* out, void* stream) {
  return gather<float>(px, py, pz, w, K, nc, cb, zmajor, nx, x0, slab, inv_h, ext, grids, D,
                       out, stream);
}

// The same two in double: every position, weight and mesh array float64.
extern "C" int cic_deposit_launch_f64(const double* px, const double* py, const double* pz,
                                      const double* w, int K, int nc, int cb, int zmajor,
                                      int nx, int x0, int slab, double inv_h, const int* ext,
                                      double* grid, void* stream) {
  return deposit<double>(px, py, pz, w, K, nc, cb, zmajor, nx, x0, slab, inv_h, ext, grid,
                         stream);
}

extern "C" int cic_gather_launch_f64(const double* px, const double* py, const double* pz,
                                     const double* w, int K, int nc, int cb, int zmajor,
                                     int nx, int x0, int slab, double inv_h, const int* ext,
                                     const double* grids, int D, double* out, void* stream) {
  return gather<double>(px, py, pz, w, K, nc, cb, zmajor, nx, x0, slab, inv_h, ext, grids, D,
                        out, stream);
}

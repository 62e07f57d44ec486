// Hopper kernels of the individual-level blocked-Gibbs SNP sweep.
//
// Built with nvcc into a shared library with a plain C interface
// (hibayes_tpu_torch/ops/build.py) and called through ctypes
// (hibayes_tpu_torch/ops/blockgibbs.py).  Every entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
//
// They replace the TPU kernels of hibayes_tpu/ops/blockgibbs.py:
//   draws_kernel  <- _kernel_s_block_t / _s_block_draws   (:1264-1322), and
//                    the draw stage of the three sweeps below
//   hb_sweep_mc   <- _kernel_mc_t  / sweep_mc_t           (:642-764)
//                    _kernel_mc_ti / sweep_mc_ti          (:777-909)
//                    _kernel_mc_tc / sweep_mc_tc          (:937-1095)
//                    _kernel_mc    / sweep_mc             (:318-523), K >= 2
//                    and, at K = 1, the single-chain sweeps
//                    _kernel         / sweep              (:138-315)
//                    _kernel_chunked / sweep_chunked      (:1371-1589)
//
// The TPU sweeps keep a whole X block (n x B) in VMEM and carry yadj/u
// across an in-order grid.  On Hopper a block has at most 227 KB of shared
// memory (an int8 X block is 6.4 MB at n = 50,000) and CTAs run in no order.
//
// One chain (K = 1) is one persistent launch a sweep, sweep1_kernel: a
// grid no larger than the CTAs the card holds at once (checked with the
// occupancy API), ordered by release/acquire flags whose values run on
// across sweeps by an epoch; a wait of 10 s traps instead of hanging the
// card (pdl.cuh).  The rows of n are cut into the row tiles the caller
// picks (about one per SM but the drawer's), and each CTA owns some of
// them for the whole sweep, keeping their yadj and u in shared memory.
//
// The right-hand side runs one block ahead.  Block b+1's draws need
// X_{b+1}' yadj_b, where yadj_b = yadj_{b-1} + X_b dg_b; that is
// X_{b+1}' yadj_{b-1} + C_{b+1} dg_b, with C_{b+1} = X_{b+1}' X_b the
// cross-Gram of consecutive blocks (made at set-up, GibbsData.C_blocks).
// The first term, the row work, needs only dg_{b-1}, so it runs under
// block b's draw chain; the second is a B x B matvec the drawer makes
// between two chains.  The same conditional, in float32 as before.
//   - CTA 0, the drawer: warp 0 runs block b's B draws (draws.cuh) and
//     publishes dg_b.  Meanwhile warps 1-7 stage the packed rows P_{b+1},
//     one of their threads has the copy engine bring W_{b+1} (64 KB at
//     B = 128) into the other half of a double buffer (cp.async.bulk and
//     an mbarrier; where the drawer lacks the room, into the one buffer
//     once the chain is done), and they wait for block b+1's row-tile
//     partials and sum them (warp w the tiles w - 1, w + 6, ... in order).
//     Once dg_b is out and the sums are in, warps 1-4 form rhs_{b+1} = (the
//     seven sums in warp order) + C_{b+1} dg_b (a warp 32 rows of C, a lane
//     four columns, halving shuffles), and warp 0 starts chain b+1.
//     C_{b+1} lands next to W_{b+1} in shared memory (a third mbarrier), or,
//     where it does not fit, is read from L2; both reach L2 a block ahead.
//   - every CTA with tiles (the drawer too, where the tiles outnumber the
//     other CTAs): before any dg, writes its tiles' partials of blocks 0
//     and 1 against the starting yadj; then, once dg_b is published,
//     applies yadj += X_b dg_b, u -= X_b dg_b to its rows (a row a thread
//     pair) and writes its partials X_{b+2}' yadj (a warp a row class, a
//     lane a column group) into the half of a double buffer that block
//     b+2's parity names, each tile's published by a flag.  X_b, X_{b+1}
//     and X_{b+2} are staged in shared memory under the chain (cp.async,
//     16-byte units rotated by the row so both access patterns spread over
//     the banks) where three tiles fit; where one fits it holds X_b (the
//     correction's) and X_{b+2} is read from global memory after an L2
//     prefetch.
// Bound: the larger of the chain side (the draw chain, the matvec, a
// barrier) and the row side (a flag hand-off, a row tile's correction and
// partials, the flags and the drawer's sums); X moves at 3.35 TB/s under
// both.  Every sum runs in an order fixed by n, B and the tiling: a row's
// correction is a lane's four columns then a shuffle tree over the warp
// (evaluated by the thread pair); a tile's partial is, for each of 32 row
// classes (row mod 32 within the tile), a sum over the class's rows in
// order, then the 32 added in class order; so a relaunch is bit for bit
// the same.
//
// K >= 2 chains are a sequence of launches on one stream, two per SNP
// block:
//   rows_mc_kernel  (K >= 2, the port of _kernel_mc's two products) grid
//                 over row tiles of n (the caller picks the tile size):
//                 applies the previous block's effect changes (yadj +=
//                 X_{b-1} dg, u -= X_{b-1} dg) to its rows, then writes its
//                 partial X_b' yadj (K, B), X read once for all chains.
//                 Its bound is X's bytes at small K (an int8 block
//                 of 6.4 MB, 1.9 us at 3.35 TB/s for K = 4, n = 50,176) and
//                 the float32 FMAs at large K (4 K n B: 2.0 us at 67 TFLOP/s
//                 for K = 64, n = 4,096); the first design, which staged one
//                 32-row chunk at a time in registers with two barriers per
//                 chunk and one shared load per FMA or so, reached neither
//                 (PERF.md).  The design:
//                   - a ring of chunks of 32 or 64 rows of X_{b-1} and X_b in
//                     shared memory, filled by cp.async two (f32) or three
//                     (int8) chunks ahead; int8 stays int8 there and is
//                     converted on read with a byte permute and one add;
//                     a row's 4-column groups are rotated by the row, so the
//                     lanes of a warp that read one column of 32 rows hit 32
//                     banks;
//                   - register tiles: for the residual update a lane holds
//                     TK chains x TR rows (each X and dg value it loads
//                     feeds TK or TR FMAs); for X_b' yadj a lane holds TK
//                     chains x TC columns, yadj read four rows at a time;
//                   - the tile shape is a template chosen by the batch, so
//                     every warp has work at small K too: at K <= 4 a task
//                     is one chain and half the chunk's rows (or columns).
//                 Each output element is still summed by one thread, over
//                 the columns (residual) or the tile's rows (partial) in
//                 order, so chain k's sums depend on n, B and the row tiling
//                 alone: not on K, and not on the tile shape.
//   draws_kernel  one CTA per chain.  Loads W_b (64 KB at B = 128) and the
//                 chain's packed rows into shared memory, then its eight
//                 warps sum the chain's row-tile partials (warp w the tiles
//                 w, w + 8, ... in order, the eight sums in warp order: no
//                 atomics, and an order that depends on the tile count
//                 alone), and one warp runs the B sequential draws
//                 (draws.cuh).  Bound by the latency of that dependent chain.
//                 block_draws launches it too.
//
// Every launch of a K >= 2 sweep but the first overlaps the one before it
// (programmatic dependent launch, pdl.cuh): a rows launch puts its first X
// chunks in flight, a draws launch loads W_b and the packed rows, and only
// then does each wait for the launch before it and read dg, yadj or the
// partials.  A rows launch lets the next draws launch start at once, so W_b
// arrives while the draws before still run their chain (when device memory
// is idle); a draws launch lets the next rows launch start once its own
// wait is over.  A last rows launch applies the final block's changes.
//
// X and W are indexed by the GLOBAL block off + b; the packed rows and
// outputs by the local b (sweep_mc_tc reads W by the local block, a
// TPU-side fault this port does not copy).  Any n is taken: the ragged last
// tile is masked here.
//
// With a stamps buffer (measurement only) the kernels record %globaltimer
// (and clock64) at their stages (hb_sweep_mc).

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"
#include "pdl.cuh"

namespace hb {

constexpr int kDrawWarps = 8;
constexpr int kDrawThreads = kWarp * kDrawWarps;

// sweep1_kernel: 8 warps a CTA; a tile's rows fall in 32 classes (row mod
// 32 within the tile: the warps of the two-launch design it replaced, whose
// sums it keeps), warp w taking classes 4w .. 4w + 3.
constexpr int kS1Warps = 8;
constexpr int kS1Threads = kWarp * kS1Warps;
constexpr int kS1Classes = 32;
constexpr int kS1PerWarp = kS1Classes / kS1Warps;
constexpr int kS1BarFloats = 8;   // the drawer's three mbarriers (W's two, C's), 16-byte padded
constexpr int kS1SumWarps = kS1Warps - 1;   // the drawer's warps that sum the partials
constexpr int kS1SumLoads = 20;             // partials' loads a summing lane keeps in flight

// rows_mc_kernel: 8 warps; a CTA serves up to kMcChains chains (grid.y =
// ceil(K / kMcChains)).
constexpr int kMcWarps = 8;
constexpr int kMcThreads = kWarp * kMcWarps;
constexpr int kMcChains = 64;

// Stamps per block in the stamps buffer.  K >= 2, %globaltimer ns: rows
// launch (start, after its wait, end), draws launch (start, W and P loaded,
// after its wait, partials summed, draws done); then clock64 of
// rows_mc_kernel's first CTA: after its wait, and through its first chunk
// after the first barrier, after the next chunk's copies are issued, after
// the residual update, after the second barrier and after the partials; at
// its end.  K = 1 (sweep1_kernel), %globaltimer ns, record b: the drawer's
// warp 0 once W_b has landed, as chain b starts (2), after its draws (6),
// once dg_b is published (3); its warp 1 as it starts block b's round (0),
// once the flags of its first tiles of block b+1 are seen (5), once its
// sum of block b+1's partials is stored (14), once dg_b is published,
// every warp's sum is stored and C_{b+1} has landed (15: after the wait
// for C, since a timer read that follows a barrier alone may be scheduled
// before it); thread 0 once rhs_{b+1} = partials + C_{b+1} dg_b is formed
// (7), after its own row work of step b + 1 (4); CTA 1 at step b: before
// its wait for dg_{b-1} (8), once dg and its X tiles are in (9), after its
// correction yadj += X_{b-1} dg_{b-1} (11), after its first tile's
// partials of block b+1 (at b = 0: of blocks 0 and 1) are formed (12) and
// written (13), once all are published (10).
constexpr int kStamps = 16;

// Launches of each kernel, counted where it is launched (hb_launch_counts).
long long g_sweep1_launches = 0;
long long g_rows_mc_launches = 0;
long long g_draws_launches = 0;

__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
}

// Four int8 values of one 32-bit word as exact floats: each byte, its sign
// bit flipped, becomes the low mantissa byte of 2^23 + 128 + x (a byte
// permute), and one add takes 2^23 + 128 away.  Two full-rate instructions
// in place of a quarter-rate conversion.
__device__ __forceinline__ float byte_float(unsigned w, int i) {
  return __int_as_float(static_cast<int>(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                                     0x7440u | i))) - 8388736.f;
}

__device__ __forceinline__ void stamp(long long* s, int i) {
  if (s != nullptr) s[i] = global_ns();
}

__device__ __forceinline__ void stamp_clock(long long* s, int i) {
  if (s != nullptr) s[i] = clock64();
}

// ---------------------------------------------------------------------------
// sweep1_kernel: one chain, one persistent launch a sweep
// ---------------------------------------------------------------------------

// Shared memory of a sweep1_kernel CTA, in bytes: the drawer's part (CTA 0
// only: three mbarriers, wb buffers of W_b and cb of C_b (each B B), the
// packed rows double-buffered at padded_stride (2 B RP), the seven summing
// warps' partial sums, dg_b and rhs_{b+1} (9 B)); then, for a CTA with T
// row tiles of rpt rows, yadj and u of its rows (each padded to 4 floats),
// dg of the block before (B), the 32 row classes' sums (32 B) and nb X
// tile buffers per tile (ops/blockgibbs.py:sweep1_smem mirrors it).
struct S1Layout {
  size_t draw_bytes, yu_floats, tile_bytes, total;
};

__host__ __device__ inline S1Layout s1_layout(int B, int RP, int rpt, int xbytes, int T,
                                              int nb, bool drawer, int wb, int cb) {
  S1Layout L;
  L.draw_bytes = drawer ? sizeof(float) * (kS1BarFloats + static_cast<size_t>(wb + cb) * B * B +
                                           2 * static_cast<size_t>(B) * RP +
                                           (kS1SumWarps + 2) * B)
                        : 0;
  L.yu_floats = (static_cast<size_t>(T) * rpt + 3) / 4 * 4;
  L.tile_bytes = static_cast<size_t>(rpt) * B * xbytes;
  L.total = L.draw_bytes +
            (T > 0 ? sizeof(float) * (2 * L.yu_floats + static_cast<size_t>(kS1Classes + 1) * B) +
                         static_cast<size_t>(T) * nb * L.tile_bytes
                   : 0);
  return L;
}

template <typename XT>
struct Sweep1Args {
  const XT* X;        // (nb_tot, n, B)
  const float* W;     // (nb_tot, B, B)
  const float* C;     // (nb_tot, B, B): C[k] = X_k' X_{k-1}
  const float* P;     // (nbg, B, R) packed rows
  int off, nbg, n, B, rpt, ntiles;
  float *yadj, *u;    // (n,), updated
  float *g_out, *dg_out, *tr_out;   // (nbg B,)
  float* partial;     // (2, ntiles, B): block b's in half b mod 2
  unsigned* flags;    // [0] dg_b published; [1 + t] tile t's partials of block b published
  unsigned epoch;     // this sweep publishes epoch + b + 1 for block b
  int nb0, nbr;       // X tile buffers a tile of the drawer / of another CTA has (3, 1 or 0)
  int wb;             // buffers of W: 2, W_{b+1} lands under block b's chain;
                      // 1, after it (the drawer then has room for its tile's X)
  int cb;             // buffers of C: 1, C_{b+1} lands under block b's chain; 0, read from L2
  long long* stamps;  // measurement only (null in use)
  int nf;             // BayesR folds (read by the NF = kRuntimeFold instance)
  // the packed rows in global memory, SNP-major at padded_stride(R) (nbg B,
  // RP), read there by the draws (through L2) instead of staged in shared
  // memory: where one SNP's rows overflow it; null: staged from P
  const float* Pg;
};

// A row tile of X as the row work reads it: in global memory as stored, or
// in shared memory where, when a row's bytes are a multiple of 16 (int8
// with B % 16 == 0, or float32), each row is U units of 16 bytes and unit u
// of row r sits at (u + r) mod U.  So a warp whose lanes read one unit of
// 32 consecutive rows (the correction, a row a thread) and a warp whose
// lanes read one row (the partials, a column group a lane) both spread
// over the banks.  Column group l is columns 4l .. 4l + 3.
template <typename XT>
struct S1Tile {
  const unsigned char* base;   // row 0
  int rb;                      // bytes a row: B sizeof(XT)
  int U;                       // 16-byte units a row, or 0 (rows not a multiple of 16 bytes)
  bool rot;                    // units rotated by the row (a tile in shared memory)

  // the stored place of unit u of a row whose rotation is rm (= r mod U)
  __device__ __forceinline__ int pos(int u, int rm) const {
    if (!rot) return u;
    const int p = u + rm;
    return p >= U ? p - U : p;
  }
  // column group l of row r (rotation rm) as four exact floats
  __device__ __forceinline__ void group(int r, int rm, int l, float x[4]) const {
    const unsigned char* row = base + static_cast<size_t>(r) * rb;
    if constexpr (sizeof(XT) == 1) {
      const int at = U > 0 ? 16 * pos(l >> 2, rm) + 4 * (l & 3) : 4 * l;
      const unsigned w = *reinterpret_cast<const unsigned*>(row + at);
      x[0] = byte_float(w, 0); x[1] = byte_float(w, 1);
      x[2] = byte_float(w, 2); x[3] = byte_float(w, 3);
    } else {
      const float4 v = *reinterpret_cast<const float4*>(row + 16 * pos(l, rm));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  }
};

// The row tiles of one CTA: t_first, t_first + G, ..., T of them, each with
// yadj and u in shared memory and nb buffers of X: 3, block b in buffer
// b mod 3 (step s reads X_{s-1} and X_{s+1} and keeps X_s for the next);
// 1, X_{s-1} (the correction's) in shared memory, X_{s+1} (the partials')
// read from global memory after an L2 prefetch under the chain; 0, both
// read from global memory.
template <typename XT>
struct S1Rows {
  int t_first, T, nb, G;
  float *ys, *us, *dgs, *red;
  unsigned char* xbuf;
  size_t tile_bytes;

  __device__ unsigned char* buf(int k, int blk) const {
    return xbuf + (static_cast<size_t>(k) * nb + (nb == 3 ? blk % 3 : 0)) * tile_bytes;
  }
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Tile k of the CTA (rows r0 .. r0 + nr) of local block sb: in global memory.
template <typename XT>
__device__ __forceinline__ const unsigned char* s1_global(const Sweep1Args<XT>& a, int sb,
                                                          int r0) {
  return reinterpret_cast<const unsigned char*>(
      a.X + (static_cast<size_t>(a.off + sb) * a.n + r0) * a.B);
}

// The X tiles later steps read, started on their way.  Before the first
// step (s = -1): X_0 and X_1, into the buffers (nb 3) or into L2.  At nb 1,
// once step s no longer reads the buffer (``copies``: at s = 0 its start,
// else after its correction), X_s into it (the next correction's), so that
// its 1-2 MB land under the step's partials.  At the end of step s, under
// the wait for dg_s: nb 3, X_{s+2} into the buffer of X_{s-1} (a tile of a
// few hundred rows); nb 1, X_{s+2} into L2 (the next partials'); nb 0, X_s
// and X_{s+2} into L2.  Copies into shared memory go by cp.async (16 bytes
// to the rotated place, or 4 bytes as stored), one commit group.
template <typename XT>
__device__ __forceinline__ void s1_stage(const Sweep1Args<XT>& a, const S1Rows<XT>& w, int s,
                                         bool copies) {
  const int rb = a.B * static_cast<int>(sizeof(XT));
  const int U = rb % 16 == 0 ? rb / 16 : 0;
  int into[2] = {-1, -1}, l2[2] = {-1, -1};   // blocks into shared memory, into L2
  if (s < 0) {
    int* both = w.nb == 3 ? into : l2;
    both[0] = 0;
    both[1] = 1;
  } else if (copies) {
    into[0] = w.nb == 1 ? s : -1;
  } else if (w.nb == 3) {
    into[0] = s + 2;
  } else {
    l2[0] = w.nb == 0 ? s : -1;
    l2[1] = s + 2;
  }
  for (int k = 0; k < w.T; ++k) {
    const int r0 = (w.t_first + k * w.G) * a.rpt;
    const int nr = min(a.rpt, a.n - r0);
    for (int i = 0; i < 2; ++i) {
      const int blk = into[i];
      if (blk < 0 || blk >= a.nbg) continue;
      const unsigned char* src = s1_global(a, blk, r0);
      unsigned char* dst = w.buf(k, blk);
      if (U > 0) {
        // unit u of row r to place p = (u + r) mod U; a thread's units step
        // by kS1Threads: (r, u, p) advance with a carry, no division a unit
        const int dr = kS1Threads / U, du = kS1Threads % U, dp = (dr + du) % U;
        int r = threadIdx.x / U, u = threadIdx.x % U, p = (u + r) % U;
        while (r < nr) {
          cp_async16(dst + r * rb + 16 * p, src + r * rb + 16 * u);
          r += dr;
          u += du;
          p += dp;
          if (p >= U) p -= U;
          if (u >= U) {
            u -= U;
            ++r;
            if (++p == U) p = 0;
          }
        }
      } else {
        for (int e = 4 * threadIdx.x; e < nr * rb; e += 4 * kS1Threads) cp_async4(dst + e, src + e);
      }
    }
    for (int i = 0; i < 2; ++i) {
      const int blk = l2[i];
      if (blk < 0 || blk >= a.nbg) continue;
      const unsigned char* src = s1_global(a, blk, r0);
      for (int e = 128 * threadIdx.x; e < nr * rb; e += 128 * kS1Threads) prefetch_l2(src + e);
    }
  }
  cp_async_commit();
}

// The warp-per-row design's shuffle tree over a row's 32 column-group
// products p(l), as one thread evaluates it: T(l, 16) = p(l) + p(l + 16),
// T(l, o) = T(l, 2o) + T(l + o, 2o), the row's correction T(0, 1).  Each
// leaf is formed where it is needed, so no array of 32 stays live.
template <int L, int O, typename F>
__device__ __forceinline__ float s1_tree(const F& p) {
  if constexpr (O == kWarp / 2) {
    const float a = p(L);
    return a + p(L + O);
  } else {
    const float a = s1_tree<L, 2 * O>(p);
    return a + s1_tree<L + O, 2 * O>(p);
  }
}

// yadj += X dg, u -= X dg on a tile's rows, two threads a row: the row's
// column groups' products x0 d0 + x1 d1 + x2 d2 + x3 d3 (0 past B), the
// even groups' half of the shuffle tree of the warp-per-row design
// (s1_tree) in one thread and the odd groups' in its neighbour, then their
// sum: the same sums in the same order.  dgs holds dg in shared memory.
template <typename XT>
__device__ __forceinline__ void s1_correct(const S1Tile<XT>& X, float* yk, float* uk, int nr,
                                           int B, const float* dgs) {
  const int ng = B / 4;
  const int h = threadIdx.x & 1;
  for (int r0 = 0; r0 < nr; r0 += kS1Threads / 2) {   // uniform across the warp
    const int r = r0 + threadIdx.x / 2;
    const int rc = r < nr ? r : nr - 1;
    const int rm = X.rot ? rc % X.U : 0;
    const auto p = [&](int l) {   // branch-free: column group l + h of the row
      const int lh = l + h;
      const int lg = lh < ng ? lh : 0;
      float x[4];
      X.group(rc, rm, lg, x);
      const float4 d = *reinterpret_cast<const float4*>(dgs + 4 * lg);
      const float v = x[0] * d.x + x[1] * d.y + x[2] * d.z + x[3] * d.w;
      return lh < ng ? v : 0.f;
    };
    const float half = s1_tree<0, 2>(p);   // T(h, 2)
    const float delta = half + __shfl_down_sync(0xffffffffu, half, 1);
    if (h == 0 && r < nr) {
      yk[r] = yk[r] + delta;
      uk[r] = uk[r] - delta;
    }
  }
}

// The tile's partials X' yadj by row class: warp w takes the classes
// w, w + 8, w + 16, w + 24, lane l the column group l; acc[k][q] sums
// X[r, 4l + q] yadj[r] over class w + 8k's rows in order.  Each class's
// row rotation steps along with its rows (the last group's rows past the
// tile read row nr - 1 and add nothing).
template <typename XT>
__device__ __forceinline__ void s1_partials(const S1Tile<XT>& X, const float* yk, int nr, int B,
                                            float acc[kS1PerWarp][4]) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (4 * lane >= B) return;
  const int step = X.rot ? kS1Classes % X.U : 0;
  int rm[kS1PerWarp];
#pragma unroll
  for (int k = 0; k < kS1PerWarp; ++k) rm[k] = X.rot ? (warp + kS1Warps * k) % X.U : 0;
#pragma unroll 2
  for (int g0 = 0; g0 < nr; g0 += kS1Classes) {
    float x[kS1PerWarp][4], y[kS1PerWarp];
#pragma unroll
    for (int k = 0; k < kS1PerWarp; ++k) {   // every load of the group first
      const int r = g0 + warp + kS1Warps * k;
      const int rc = r < nr ? r : nr - 1;
      X.group(rc, rm[k], lane, x[k]);
      y[k] = yk[rc];
    }
#pragma unroll
    for (int k = 0; k < kS1PerWarp; ++k) {
      if (g0 + warp + kS1Warps * k < nr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] += x[k][q] * y[k];
      }
      rm[k] += step;
      if (X.rot && rm[k] >= X.U) rm[k] -= X.U;
    }
  }
}

// Step s of a CTA's row tiles (s = 0 .. nbg): once dg_{s-1} is published,
// yadj += X_{s-1} dg_{s-1}, u -= X_{s-1} dg_{s-1} on its rows (s > 0); then
// each tile's partial X_{s+1}' yadj, one block ahead (at s = 0, before any
// dg: X_0' yadj and X_1' yadj), its 32 row classes added in order, written
// to the half of the partials that the block's parity names and published
// by the tile's flag; the X tiles of later steps are staged as their
// buffers come free (s1_stage).  Row r of a tile is in class r mod 32.
// All threads of the CTA call it.
template <typename XT>
__device__ __forceinline__ void s1_rows_step(const Sweep1Args<XT>& a, const S1Rows<XT>& w, int s,
                             long long* st) {
  const int B = a.B;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = 4 * lane;
  const int rb = B * static_cast<int>(sizeof(XT));
  const int U = rb % 16 == 0 ? rb / 16 : 0;
  if (st != nullptr && threadIdx.x == 0) st[s * kStamps + 8] = global_ns();
  if (s > 0 && threadIdx.x == 0) spin_acquire(a.flags, a.epoch + s);   // dg_{s-1} published
  cp_async_wait<0>();
  __syncthreads();   // dg_{s-1} visible; this step's X tiles landed
  if (st != nullptr && threadIdx.x == 0) st[s * kStamps + 9] = global_ns();
  if (s == 0) s1_stage(a, w, 0, true);
  if (s > 0) {
    for (int i = threadIdx.x; i < B; i += kS1Threads)
      w.dgs[i] = __ldcg(a.dg_out + static_cast<long long>(s - 1) * B + i);
    __syncthreads();
    for (int k = 0; k < w.T; ++k) {
      const int r0 = (w.t_first + k * w.G) * a.rpt;
      const S1Tile<XT> Xp = w.nb >= 1 ? S1Tile<XT>{w.buf(k, s - 1), rb, U, U > 0}
                                      : S1Tile<XT>{s1_global(a, s - 1, r0), rb, U, false};
      s1_correct(Xp, w.ys + k * a.rpt, w.us + k * a.rpt, min(a.rpt, a.n - r0), B, w.dgs);
    }
    __syncthreads();   // yadj of every row updated; X_{s-1}'s buffer read
    s1_stage(a, w, s, true);
  }
  if (st != nullptr && threadIdx.x == 0) st[s * kStamps + 11] = global_ns();
  for (int blk = s == 0 ? 0 : s + 1; blk <= s + 1 && blk < a.nbg; ++blk) {
    float* part = a.partial + static_cast<long long>(blk & 1) * a.ntiles * B;
    for (int k = 0; k < w.T; ++k) {
      const int t = w.t_first + k * w.G;
      const int r0 = t * a.rpt;
      const S1Tile<XT> Xc = w.nb == 3 ? S1Tile<XT>{w.buf(k, blk), rb, U, U > 0}
                                      : S1Tile<XT>{s1_global(a, blk, r0), rb, U, false};
      float acc[kS1PerWarp][4];
#pragma unroll
      for (int v = 0; v < kS1PerWarp; ++v)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[v][q] = 0.f;
      s1_partials(Xc, w.ys + k * a.rpt, min(a.rpt, a.n - r0), B, acc);
      const bool mark = st != nullptr && threadIdx.x == 0 && k == 0 && blk == s + 1;
      if (mark) st[s * kStamps + 12] = global_ns();
      if (c0 < B) {
#pragma unroll
        for (int v = 0; v < kS1PerWarp; ++v)
#pragma unroll
          for (int q = 0; q < 4; ++q) w.red[(warp + kS1Warps * v) * B + c0 + q] = acc[v][q];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < B; c += kS1Threads) {
        float sum = 0.f;
#pragma unroll 8
        for (int r = 0; r < kS1Classes; ++r) sum += w.red[r * B + c];
        part[static_cast<long long>(t) * B + c] = sum;
      }
      __syncthreads();   // the partial written; red free again
      if (mark) st[s * kStamps + 13] = global_ns();
      if (threadIdx.x == 0) publish(a.flags + 1 + t, a.epoch + blk + 1);
    }
  }
  __syncthreads();   // every X buffer of this step read
  if (st != nullptr && threadIdx.x == 0) st[s * kStamps + 10] = global_ns();
  s1_stage(a, w, s, false);
}

// The drawer's warps 1-7 sum block blk's row-tile partials: warp w the
// tiles w - 1, w + 6, ... in order (lane l the columns 4l .. 4l + 3) into
// red[w - 1]; lane l waits for the flag of the warp's (l + 1)-th tile of
// each 32 (polling with naps, so that warp 0's chain keeps the issue slots),
// kS1SumLoads tiles' loads in flight at a time (one round at 131 tiles).
// sb (warp 1's lane 0, measurement only): stamps 5 and 14.
template <typename XT>
__device__ __forceinline__ void s1_sum_partials(const Sweep1Args<XT>& a, float* red, int blk,
                                                long long* sb) {
  const int v = threadIdx.x / kWarp - 1;
  const int lane = threadIdx.x % kWarp;
  const int B = a.B, c0 = 4 * lane;
  const float* part = a.partial + static_cast<long long>(blk & 1) * a.ntiles * B;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = v; t0 < a.ntiles; t0 += kS1SumWarps * kWarp) {
    const int t = t0 + kS1SumWarps * lane;
    if (t < a.ntiles) await_nap(a.flags + 1 + t, a.epoch + blk + 1);
    __syncwarp();   // every tile this warp sums is published
    if (t0 == v) stamp(sb, 5);
    const int tend = min(a.ntiles, t0 + kS1SumWarps * kWarp);
    if (c0 < B) {
      for (int tb = t0; tb < tend; tb += kS1SumLoads * kS1SumWarps) {
        float4 x[kS1SumLoads];
#pragma unroll
        for (int i = 0; i < kS1SumLoads; ++i) {
          const int tt = tb + i * kS1SumWarps;
          if (tt < tend)
            x[i] = __ldcg(
                reinterpret_cast<const float4*>(part + static_cast<long long>(tt) * B + c0));
        }
#pragma unroll
        for (int i = 0; i < kS1SumLoads; ++i) {
          if (tb + i * kS1SumWarps < tend) {
            acc.x += x[i].x; acc.y += x[i].y; acc.z += x[i].z; acc.w += x[i].w;
          }
        }
      }
    }
  }
  if (c0 < B) *reinterpret_cast<float4*>(red + v * B + c0) = acc;
  stamp(sb, 14);
}

// Entry i of a block's summed partials: the seven warps' sums in warp order.
__device__ __forceinline__ float s1_psum(const float* red, int B, int i) {
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < kS1SumWarps; ++v) sum += red[v * B + i];
  return sum;
}

// One halving exchange of s1_rhs: a lane keeps rows [0, H) or [H, 2H) of
// its 2H (by its lane bit O) and adds its partner's values of them.
template <int H, int O>
__device__ __forceinline__ void s1_halve(float* p, int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float keep = up ? p[k + H] : p[k];
    const float give = up ? p[k] : p[k + H];
    p[k] = keep + __shfl_xor_sync(0xffffffffu, give, O);
  }
  if constexpr (H > 1) s1_halve<H / 2, O / 2>(p, lane);
}

// Warps a drawer forms rhs_{b+1} with (warps 1 .. kS1RhsWarps), rows a warp.
constexpr int kS1RhsWarps = 4;
constexpr int kS1RhsRows = kMaxBlock / kS1RhsWarps;   // 32

// rhs_{b+1} = block b+1's summed partials (X_{b+1}' yadj before dg_b) +
// C_{b+1} dg_b, by the drawer's warp v = 1 .. 4 (call it from those): rows
// i = v - 1 + 4k (k < 32) of C (in shared memory or in global memory),
// lane l columns 4l .. 4l + 3 against dg_b's; the 32 rows' lane products
// are summed over the warp by halving exchanges (lane bit 4, 3, 2, 1, 0
// keeps half of the rows and adds its partner's half of them), so lane l
// holds row k = 16 b4 + 8 b3 + 4 b2 + 2 b1 + b0 (b the lane's bits), which
// it adds to the partials' sum.  An order fixed by B.
__device__ __forceinline__ void s1_rhs(const float* C, const float* dgs, const float* red,
                                       float* rhs, int B) {
  const int v = threadIdx.x / kWarp - 1;
  const int lane = threadIdx.x % kWarp;
  const bool on = 4 * lane < B;
  const float4 d = on ? *reinterpret_cast<const float4*>(dgs + 4 * lane)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  float p[kS1RhsRows];
#pragma unroll
  for (int k = 0; k < kS1RhsRows; ++k) {
    const int i = v + kS1RhsWarps * k;
    const float4 c = on && i < B ? *reinterpret_cast<const float4*>(
                                       C + static_cast<long long>(i) * B + 4 * lane)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    p[k] = fmaf(c.w, d.w, fmaf(c.z, d.z, fmaf(c.y, d.y, c.x * d.x)));
  }
  s1_halve<kS1RhsRows / 2, kWarp / 2>(p, lane);
  const int k = 16 * ((lane >> 4) & 1) + 8 * ((lane >> 3) & 1) + 4 * ((lane >> 2) & 1) +
                2 * ((lane >> 1) & 1) + (lane & 1);
  const int i = v + kS1RhsWarps * k;
  if (i < B) rhs[i] = s1_psum(red, B, i) + p[0];
}

// grid G <= the CTAs the card holds at once (every CTA resident, so the
// flag waits cannot deadlock; one CTA an SM, so the registers are not held
// to what two would leave), kS1Threads threads, dynamic shared memory
// the larger s1_layout of CTA 0 and of the others.  CTA c owns the row
// tiles t = c - 1 (mod G); CTA 0 draws.
template <typename XT, int MI, int NF>
__global__ void __launch_bounds__(kS1Threads, 1) sweep1_kernel(Sweep1Args<XT> a) {
  const int R = packed_rows(MI, NF == kRuntimeFold ? a.nf : NF);
  const int RP = padded_stride(R);
  const bool rows_smem = !rows_may_be_global<NF>() || a.Pg == nullptr;
  const int RS = rows_smem ? RP : 0;   // floats a SNP's rows take in shared memory
  extern __shared__ __align__(16) unsigned char s1_smem[];
  const int B = a.B;
  const int G = gridDim.x;
  const bool drawer = blockIdx.x == 0;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  S1Rows<XT> w;
  w.G = G;
  w.t_first = (blockIdx.x + G - 1) % G;
  w.T = w.t_first < a.ntiles ? (a.ntiles - 1 - w.t_first) / G + 1 : 0;
  w.nb = drawer ? a.nb0 : a.nbr;
  const S1Layout L = s1_layout(B, RS, a.rpt, sizeof(XT), w.T, w.nb, drawer, a.wb, a.cb);
  w.ys = reinterpret_cast<float*>(s1_smem + L.draw_bytes);
  w.us = w.ys + L.yu_floats;
  w.dgs = w.us + L.yu_floats;
  w.red = w.dgs + B;
  w.xbuf = reinterpret_cast<unsigned char*>(w.red + kS1Classes * B);
  w.tile_bytes = L.tile_bytes;
  long long* st_rows = blockIdx.x == 1 || G == 1 ? a.stamps : nullptr;

  // the drawer's buffers
  uint64_t* bar = reinterpret_cast<uint64_t*>(s1_smem);           // W's two, C's
  float* Wb = reinterpret_cast<float*>(s1_smem) + kS1BarFloats;   // + buf B B
  float* Cb = Wb + a.wb * B * B;                                  // cb B B
  float* Pb = Cb + a.cb * B * B;                                  // + buf B RP
  float* red7 = Pb + 2 * B * RS;                                  // + v B
  float* dgd = red7 + kS1SumWarps * B;                            // dg_b
  float* rhs = dgd + B;                                           // rhs_{b+1}
  const unsigned w_bytes = static_cast<unsigned>(sizeof(float)) * B * B;
  // W_sb into buffer sb mod wb, its arrival counted on that buffer's mbarrier
  auto stage_w = [&](int sb) {   // one thread
    fence_async();   // the buffer was last read by generic loads
    const int q = sb % a.wb;
    mbar_expect(bar + q, w_bytes);
    bulk_copy(Wb + q * B * B, a.W + static_cast<size_t>(a.off + sb) * B * B, w_bytes, bar + q);
  };
  // C_sb into its buffer (counted on the third mbarrier), or into L2
  auto stage_c = [&](int sb) {   // one thread
    const float* src = a.C + static_cast<size_t>(a.off + sb) * B * B;
    if (a.cb == 0) {
      prefetch_l2(src, static_cast<long long>(w_bytes));
      return;
    }
    fence_async();
    mbar_expect(bar + 2, w_bytes);
    bulk_copy(Cb, src, w_bytes, bar + 2);
  };
  auto stage_p = [&](int sb, int t0, int nt) {   // packed rows at padded_stride
    float* dst = Pb + (sb & 1) * B * RP;
    const float* src = a.P + static_cast<size_t>(sb) * B * R;
    for (int e = t0; rows_smem && e < B * R; e += nt) {
      const int j = e / R;
      cp_async4(dst + j * RP + e - j * R, src + e);
    }
    cp_async_commit();
  };

  if (drawer) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      mbar_init(bar + 1);
      mbar_init(bar + 2);
      stage_w(0);
      if (a.nbg > 1) stage_c(1);
    }
    stage_p(0, threadIdx.x, kS1Threads);
  }
  for (int i = threadIdx.x; i < w.T * a.rpt; i += kS1Threads) {
    const int row = (w.t_first + (i / a.rpt) * G) * a.rpt + i % a.rpt;
    if (row < a.n) {
      w.ys[i] = a.yadj[row];
      w.us[i] = a.u[row];
    }
  }
  if (w.T > 0) s1_stage(a, w, -1, true);   // X_0's and X_1's tiles on their way
  // (s1_rows_step waits for the copies and synchronises first)
  if (w.T > 0) s1_rows_step(a, w, 0, st_rows);
  else {
    cp_async_wait<0>();
    __syncthreads();
  }
  if (drawer) {
    long long* st = a.stamps;
    const bool t0 = threadIdx.x == 0, t1 = threadIdx.x == kWarp;
    // rhs_0: block 0's partials summed
    if (warp > 0) s1_sum_partials(a, red7, 0, nullptr);
    __syncthreads();
    for (int i = threadIdx.x; i < B; i += kS1Threads) rhs[i] = s1_psum(red7, B, i);
    __syncthreads();
    for (int s = 0; s < a.nbg; ++s) {
      long long* sb = st != nullptr ? st + s * kStamps : nullptr;
      const bool more = s + 1 < a.nbg;
      if (warp == 0) {
        float r[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int i = kSlots * lane + q;
          r[q] = i < B ? rhs[i] : 0.f;
          gi[q] = dg[q] = tr[q] = 0.f;
        }
        mbar_wait(bar + s % a.wb, (s / a.wb) & 1);   // W_s has landed
        if (t0) stamp(sb, 2);
        // two call sites, so that the shared-memory one keeps its rows'
        // loads shared-memory loads (a pointer that may be either is generic)
        if (rows_smem)
          warp_block_draws<MI, NF>(B, Wb + (s % a.wb) * B * B, Pb + (s & 1) * B * RP, r, gi,
                                   dg, tr, 0.f, 1.f, a.nf);
        else
          warp_block_draws<MI, NF>(B, Wb + (s % a.wb) * B * B,
                                   a.Pg + static_cast<long long>(s) * B * RP, r, gi, dg, tr,
                                   0.f, 1.f, a.nf);
        if (t0) stamp(sb, 6);
        const long long lb = static_cast<long long>(s) * B;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int j = kSlots * lane + q;
          if (j < B) {
            a.dg_out[lb + j] = dg[q];
            dgd[j] = dg[q];
          }
        }
        __syncwarp();
        if (lane == 0) publish(a.flags, a.epoch + s + 1);
        if (t0) stamp(sb, 3);
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int j = kSlots * lane + q;
          if (j < B) {
            a.g_out[lb + j] = gi[q];
            a.tr_out[lb + j] = tr[q];
          }
        }
      } else {
        if (t1) stamp(sb, 0);
        if (more) {
          // under the chain: W_{s+1} by the copy engine, P_{s+1} by
          // cp.async, the next block's W and C into L2, and block s+1's
          // partials summed as they arrive
          if (t1) {
            if (a.wb == 2) stage_w(s + 1);
            if (s + 2 < a.nbg) {
              prefetch_l2(a.W + static_cast<size_t>(a.off + s + 2) * B * B,
                          static_cast<long long>(w_bytes));
              prefetch_l2(a.C + static_cast<size_t>(a.off + s + 2) * B * B,
                          static_cast<long long>(w_bytes));
            }
          }
          stage_p(s + 1, threadIdx.x - kWarp, kS1Threads - kWarp);
          s1_sum_partials(a, red7, s + 1, t1 ? sb : nullptr);
          cp_async_wait<0>();
        }
      }
      __syncthreads();   // dg_s published and in dgd; block s+1's partials summed; P_{s+1} staged
      if (more) {
        if (t1 && a.wb == 1) stage_w(s + 1);
        if (warp >= 1 && warp <= kS1RhsWarps) {   // rhs_{s+1} by warps 1-4
          if (a.cb) mbar_wait(bar + 2, s & 1);   // C_{s+1} has landed
          if (t1) stamp(sb, 15);
          s1_rhs(a.cb ? Cb : a.C + static_cast<size_t>(a.off + s + 1) * B * B, dgd, red7,
                 rhs, B);
        }
      }
      __syncthreads();   // rhs_{s+1} formed; C_{s+1} read
      if (more && a.cb && t1 && s + 2 < a.nbg) stage_c(s + 2);
      if (t0) stamp(sb, 7);
      if (w.T > 0) s1_rows_step(a, w, s + 1, nullptr);
      if (t0) stamp(sb, 4);
    }
  } else {
    for (int s = 1; s <= a.nbg; ++s) s1_rows_step(a, w, s, st_rows);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < w.T * a.rpt; i += kS1Threads) {
    const int row = (w.t_first + (i / a.rpt) * G) * a.rpt + i % a.rpt;
    if (row < a.n) {
      a.yadj[row] = w.ys[i];
      a.u[row] = w.us[i];
    }
  }
}

// ---------------------------------------------------------------------------
// rows_mc_kernel
// ---------------------------------------------------------------------------

// Chunks of X a rows_mc_kernel CTA keeps in flight: int8 chunks are small.
template <typename XT>
__host__ __device__ constexpr int mc_stages() { return sizeof(XT) == 1 ? 3 : 2; }

__device__ __forceinline__ void smem4(const int8_t* p, float v[4]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  v[0] = byte_float(w, 0); v[1] = byte_float(w, 1);
  v[2] = byte_float(w, 2); v[3] = byte_float(w, 3);
}

__device__ __forceinline__ void smem4(const float* p, float v[4]) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
}

// Two values at element offset o (0 or 2) of a 4-group.
__device__ __forceinline__ void smem2(const int8_t* p, int o, float v[2]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  v[0] = byte_float(w, o); v[1] = byte_float(w, o + 1);
}

__device__ __forceinline__ void smem2(const float* p, int o, float v[2]) {
  const float2 c = *reinterpret_cast<const float2*>(p + o);
  v[0] = c.x; v[1] = c.y;
}

template <typename XT>
__device__ __forceinline__ void copy4(XT* dst, const XT* src) {
  if constexpr (sizeof(XT) == 1) cp_async4(dst, src);
  else cp_async16(dst, src);
}

// Shared memory of rows_mc_kernel in bytes: the ring (stages x {X_{b-1},
// X_b} x rows x B in X's type), the previous block's dg of the CTA's kc
// chains (kc, B) and the chunk's updated yadj (kc, rows).
inline size_t rows_mc_smem(int B, int kc, int rows, int stages, int xbytes) {
  return static_cast<size_t>(stages) * 2 * rows * B * xbytes +
         sizeof(float) * (static_cast<size_t>(kc) * B + static_cast<size_t>(kc) * rows);
}

// grid (ntiles, ceil(K / kMcChains)), kMcThreads threads, dynamic shared
// memory rows_mc_smem.  Tile t holds rows [t * rows_per_tile, (t + 1) *
// rows_per_tile) of n, walked in chunks of CR = 32 TR RB rows (the last may
// be partial).  In shared memory, row r of a chunk keeps its 4-column group
// v at position (v + r) mod (B / 4).  Per chunk, for the CTA's chains:
//   residual update: warp w takes chains (w / RB) TK .. + TK - 1 and rows
//     (w % RB) 32 TR + lane + 32 t, t < TR; delta = X_{b-1}[row, :] .
//     dg_{b-1}[k, :], summed over the columns in order; yadj += delta,
//     u -= delta;
//   partial: warp w takes chains (w / NCB) TK .. + TK - 1 and columns
//     (w % NCB) 32 TC + TC lane .. + TC - 1 (NCB = 128 / (32 TC));
//     acc[k, c] += X_b[row, c] yadj[k, row] over the tile's rows in order.
// Each sum runs in one thread in an order fixed by n, B and the tiling,
// so chain k of a K = 8 and a K = 64 launch is bit for bit the same, and a
// chain is reproducible run to run.  Xprev == nullptr skips the residual
// update, Xcur == nullptr the partials.
template <typename XT, int TK, int TR, int RB, int TC>
__global__ void __launch_bounds__(kMcThreads)
rows_mc_kernel(const XT* __restrict__ Xprev, const float* __restrict__ dgprev,
               long long dg_stride, const XT* __restrict__ Xcur, int n, int B,
               int rows_per_tile, int K, float* __restrict__ yadj,
               float* __restrict__ u, float* __restrict__ partial, long long* stamps) {
  constexpr int CR = kWarp * TR * RB;
  constexpr int S = mc_stages<XT>();
  constexpr int NCB = kMaxBlock / (kWarp * TC);
  static_assert(TC == 2 || TC == 4, "a lane takes 2 or 4 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XT* ring = reinterpret_cast<XT*>(smem_raw);
  const int chunk = CR * B;   // elements of one X chunk
  const int k0 = blockIdx.y * kMcChains;
  const int kc = min(kMcChains, K - k0);
  float* dgs = reinterpret_cast<float*>(smem_raw + static_cast<size_t>(S) * 2 * chunk * sizeof(XT));
  float* ys = dgs + kc * B;   // (kc, CR)
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nv = B / 4;
  const bool prev = Xprev != nullptr;
  const bool cur = Xcur != nullptr;
  const bool first_cta = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  long long* st = first_cta ? stamps : nullptr;
  stamp(st, 0);
  const int row_begin = blockIdx.x * rows_per_tile;
  const int row_end = min(n, row_begin + rows_per_tile);
  const int nchunks = row_begin < row_end ? (row_end - row_begin + CR - 1) / CR : 0;

  // chunk ch of both X blocks into stage ch % S, one commit group (empty
  // past the last chunk, so the group count stays in step).  A thread's
  // pieces (row r, 4-column group v, stored at group (v + r) mod nv) step
  // by kMcThreads pieces: the row and group advance by (dr, dv) with a
  // carry, so no division runs per piece.
  const int dr = kMcThreads / nv, dv = kMcThreads % nv, ds = (dr + dv) % nv;
  const int r_first = threadIdx.x / nv, v_first = threadIdx.x % nv;
  const int s_first = (v_first + r_first) % nv;
  auto issue = [&](int ch) {
    if (ch < nchunks) {
      const int r0 = row_begin + ch * CR;
      const int nr = min(CR, row_end - r0);
      XT* sp = ring + (ch % S) * 2 * chunk;
      for (int r = r_first, v = v_first, sl = s_first; r < nr;) {
        const int at = r * B + 4 * sl;
        const size_t src = static_cast<size_t>(r0 + r) * B + 4 * v;
        if (prev) copy4(sp + at, Xprev + src);
        if (cur) copy4(sp + chunk + at, Xcur + src);
        r += dr; v += dv; sl += ds;
        if (sl >= nv) sl -= nv;
        if (v >= nv) {
          v -= nv; ++r;
          if (++sl == nv) sl = 0;
        }
      }
    }
    cp_async_commit();
  };
  release_next();   // the next draws launch may load W_b and its rows now
  for (int ch = 0; ch < S - 1; ++ch) issue(ch);
  wait_previous();   // dg, yadj and u of the launches before are visible
  stamp(st, 1);
  stamp_clock(st, 8);
  if (prev) {   // dg of the CTA's chains, one more commit group
    for (int i = threadIdx.x; i < kc * nv; i += kMcThreads) {
      const int kk = i / nv;
      cp_async16(dgs + 4 * i, dgprev + (k0 + kk) * dg_stride + 4 * (i - kk * nv));
    }
  }
  cp_async_commit();

  // the residual task of this warp
  const int kb1 = (warp / RB) * TK;
  const int rb1 = (warp % RB) * kWarp * TR + lane;
  const bool task1 = kb1 < kc;
  // the partial task of this warp
  const int kb2 = (warp / NCB) * TK;
  const int c2 = (warp % NCB) * kWarp * TC + TC * lane;
  const bool task2 = cur && kb2 < kc && c2 < B;
  float acc[TK][TC];
#pragma unroll
  for (int j = 0; j < TK; ++j)
#pragma unroll
    for (int q = 0; q < TC; ++q) acc[j][q] = 0.f;
  // yadj and u of the residual task's rows of chunk ch (zeros outside)
  float yn[TK][TR], un[TK][TR];
  auto load_yu = [&](int ch) {
    const int r0 = row_begin + ch * CR;
    const int nr = ch < nchunks ? min(CR, row_end - r0) : 0;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int kk = kb1 + j, r = rb1 + kWarp * t;
        const bool ok = kk < kc && r < nr;
        const long long at = static_cast<long long>(k0 + kk) * n + r0 + r;
        yn[j][t] = ok ? __ldcg(yadj + at) : 0.f;
        un[j][t] = ok && prev ? __ldcg(u + at) : 0.f;
      }
    }
  };
  if (task1) load_yu(0);

  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch == 0) cp_async_wait<0>();   // the first chunks and dg
    else cp_async_wait<S - 2>();
    __syncthreads();   // chunk ch landed; chunk ch - 1 used; dgs stored
    long long* sc = ch == 0 ? st : nullptr;
    stamp_clock(sc, 9);
    issue(ch + S - 1);
    stamp_clock(sc, 10);
    const XT* xp = ring + (ch % S) * 2 * chunk;
    const XT* xc = xp + chunk;
    const int r0 = row_begin + ch * CR;
    const int nr = min(CR, row_end - r0);
    if (task1) {
      float y[TK][TR], uu[TK][TR], d[TK][TR];
#pragma unroll
      for (int j = 0; j < TK; ++j) {
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          y[j][t] = yn[j][t];
          uu[j][t] = un[j][t];
          d[j][t] = 0.f;
        }
      }
      if (prev) {
        int slot[TR];
#pragma unroll
        for (int t = 0; t < TR; ++t) slot[t] = (rb1 + kWarp * t) % nv;
#pragma unroll 4
        for (int v = 0; v < nv; ++v) {
          float x[TR][4];
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            smem4(xp + (rb1 + kWarp * t) * B + 4 * slot[t], x[t]);
            slot[t] = slot[t] + 1 == nv ? 0 : slot[t] + 1;
          }
#pragma unroll
          for (int j = 0; j < TK; ++j) {
            const int kq = min(kb1 + j, kc - 1);
            const float4 g = *reinterpret_cast<const float4*>(dgs + kq * B + 4 * v);
#pragma unroll
            for (int t = 0; t < TR; ++t) {
              d[j][t] = fmaf(x[t][0], g.x, d[j][t]);
              d[j][t] = fmaf(x[t][1], g.y, d[j][t]);
              d[j][t] = fmaf(x[t][2], g.z, d[j][t]);
              d[j][t] = fmaf(x[t][3], g.w, d[j][t]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < TK; ++j) {
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            const int kk = kb1 + j, r = rb1 + kWarp * t;
            if (kk < kc && r < nr) {
              const long long at = static_cast<long long>(k0 + kk) * n + r0 + r;
              y[j][t] += d[j][t];
              yadj[at] = y[j][t];
              u[at] = uu[j][t] - d[j][t];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TK; ++j)
#pragma unroll
        for (int t = 0; t < TR; ++t)
          if (kb1 + j < kc) ys[(kb1 + j) * CR + rb1 + kWarp * t] = y[j][t];
      load_yu(ch + 1);   // in flight through the partials and the next wait
    }
    stamp_clock(sc, 11);
    __syncthreads();   // the chunk's yadj of every chain is in ys
    stamp_clock(sc, 12);
    if (task2) {
      const int v2 = c2 / 4, o2 = c2 % 4;
      int r = 0;
      int sl = v2 % nv;   // the column group's place in row r: (v2 + r) mod nv
      for (; r + 4 <= nr; r += 4) {
        float4 yv[TK];
#pragma unroll
        for (int j = 0; j < TK; ++j)
          yv[j] = *reinterpret_cast<const float4*>(ys + min(kb2 + j, kc - 1) * CR + r);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int row = r + rr;
          const XT* xr = xc + row * B + 4 * sl;
          sl = sl + 1 == nv ? 0 : sl + 1;
          float x[TC];
          if constexpr (TC == 4) smem4(xr, x);
          else smem2(xr, o2, x);
#pragma unroll
          for (int j = 0; j < TK; ++j) {
            const float yr = rr == 0 ? yv[j].x : rr == 1 ? yv[j].y : rr == 2 ? yv[j].z : yv[j].w;
#pragma unroll
            for (int q = 0; q < TC; ++q) acc[j][q] = fmaf(x[q], yr, acc[j][q]);
          }
        }
      }
      for (; r < nr; ++r) {
        const XT* xr = xc + r * B + 4 * sl;
        sl = sl + 1 == nv ? 0 : sl + 1;
        float x[TC];
        if constexpr (TC == 4) smem4(xr, x);
        else smem2(xr, o2, x);
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          const float yr = ys[min(kb2 + j, kc - 1) * CR + r];
#pragma unroll
          for (int q = 0; q < TC; ++q) acc[j][q] = fmaf(x[q], yr, acc[j][q]);
        }
      }
    }
    stamp_clock(sc, 13);
  }
  cp_async_wait<0>();
  if (partial != nullptr && task2) {
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      if (kb2 + j >= kc) continue;
      float* dst = partial + (static_cast<long long>(blockIdx.x) * K + k0 + kb2 + j) * B + c2;
#pragma unroll
      for (int q = 0; q < TC; ++q) dst[q] = acc[j][q];
    }
  }
  stamp(st, 2);
  stamp_clock(st, 14);
}

// ---------------------------------------------------------------------------
// draws_kernel
// ---------------------------------------------------------------------------

// R packed rows a SNP, staged at padded_stride(R) (R 0: none staged).
inline size_t draws_smem(int B, int R) {
  return sizeof(float) * (static_cast<size_t>(B) * B + static_cast<size_t>(B) * padded_stride(R) +
                          static_cast<size_t>(kDrawWarps) * B);
}

// grid K (one CTA per chain), kDrawThreads threads, dynamic shared memory
// draws_smem(B, R).  partial (ntiles, K, B) holds X_b' yadj in row-tile
// pieces: warp w sums the chain's tiles w, w + 8, ... (lane l columns
// 4l .. 4l+3) and warp 0 adds the eight sums in warp order, a fixed order.
// P (B, R, K) holds the packed rows of this block (staged at
// padded_stride(R) floats a SNP), or Pg (non-null) them SNP-major at
// padded_stride(R), chain k's at Pg + k pg_stride, read there (through
// L2) by the draws; W (B, B) its Gram.
// Outputs (any may be null) go to out[j * sj + k * sk].  W and P are loaded
// before the wait for the launch before (none of the sweep writes them).
template <int MI, int NF>
__global__ void __launch_bounds__(kDrawThreads)
draws_kernel(const float* __restrict__ partial, int ntiles,
             const float* __restrict__ W, const float* __restrict__ P, int B,
             int K, float* gi_out, float* dg_out, float* tr_out, long long sj,
             long long sk, long long* stamps, int nf, const float* __restrict__ Pg,
             long long pg_stride) {
  const int R = packed_rows(MI, NF == kRuntimeFold ? nf : NF);
  const int RP = padded_stride(R);
  const int RS = !rows_may_be_global<NF>() || Pg == nullptr ? RP : 0;
  extern __shared__ __align__(16) float smem[];
  const int k = blockIdx.x;
  float* Ws = smem;         // B * B
  float* Ps = Ws + B * B;   // B * RS
  float* red = Ps + B * RS; // kDrawWarps * B
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  long long* st = k == 0 && threadIdx.x == 0 ? stamps : nullptr;
  stamp(st, 3);

  if ((reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    const float4* W4 = reinterpret_cast<const float4*>(W);
    float4* Ws4 = reinterpret_cast<float4*>(Ws);
#pragma unroll 4
    for (int i = threadIdx.x; i < B * B / 4; i += blockDim.x) Ws4[i] = W4[i];
  } else {
    for (int i = threadIdx.x; i < B * B; i += blockDim.x) Ws[i] = W[i];
  }
  for (int i = threadIdx.x; RS > 0 && i < B * R; i += blockDim.x) {
    const int j = i / R;
    Ps[j * RP + i - j * R] = P[static_cast<long long>(i) * K + k];
  }
  stamp(st, 4);
  wait_previous();   // the partials of this block are visible
  release_next();
  stamp(st, 5);
  const int c0 = 4 * lane;
  if (c0 < B) {
    const float* src = partial + static_cast<long long>(k) * B + c0;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = warp; t < ntiles; t += kDrawWarps) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          src + static_cast<long long>(t) * K * B));
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    *reinterpret_cast<float4*>(red + warp * B + c0) = acc;
  }
  __syncthreads();
  if (warp != 0) return;
  float r[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = kSlots * lane + s;
    float acc = 0.f;
    if (i < B)
      for (int w = 0; w < kDrawWarps; ++w) acc += red[w * B + i];
    r[s] = acc;
    gi[s] = dg[s] = tr[s] = 0.f;
  }
  stamp(st, 6);
  if (RS > 0)   // two call sites: the shared-memory one keeps shared-memory loads
    warp_block_draws<MI, NF>(B, Ws, Ps, r, gi, dg, tr, 0.f, 1.f, nf);
  else
    warp_block_draws<MI, NF>(B, Ws, Pg + k * pg_stride, r, gi, dg, tr, 0.f, 1.f, nf);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = kSlots * lane + s;
    if (j >= B) continue;
    const long long o = j * sj + k * sk;
    if (gi_out != nullptr) gi_out[o] = gi[s];
    if (dg_out != nullptr) dg_out[o] = dg[s];
    if (tr_out != nullptr) tr_out[o] = tr[s];
  }
  stamp(st, 7);
}

// Any fold count: BayesR above kMaxFold folds runs the NF = kRuntimeFold
// instance (the caller fits its rows in shared memory: ops/blockgibbs.py
// kernel_width).
inline bool shapes_ok(int B, int R, int K, int mi, int nf) {
  return B > 0 && B <= kMaxBlock && B % 4 == 0 && K > 0 && mi >= 1 &&
         mi <= 6 && nf >= 2 && (mi == 6 || nf <= kMaxFold) && R == packed_rows(mi, nf);
}

struct DrawArgs {
  const float* partial;
  int ntiles;
  const float* W;
  const float* P;
  int B, R, K;
  float *gi, *dg, *tr;
  long long sj, sk;
  long long* stamps;
  int nf;
  const float* Pg;      // null, or the rows in global memory (draws_kernel)
  long long pg_stride;  // chain stride of Pg in floats
};

// Raise a kernel's dynamic shared memory limit to `smem` on the current
// device, once per (kernel, device, size): the sweep launches a kernel
// hundreds of times per call, and the attribute persists.
template <auto kernel>
cudaError_t set_smem(size_t smem) {
  static int dev_set = -1;
  static size_t smem_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev == dev_set && smem <= smem_set)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) {
    dev_set = dev;
    smem_set = smem;
  }
  return e;
}

template <int MI, int NF>
cudaError_t launch_draws_t(const DrawArgs& a, bool overlap, cudaStream_t stream) {
  const size_t smem = draws_smem(a.B, !rows_may_be_global<NF>() || a.Pg == nullptr ? a.R : 0);
  cudaError_t e = set_smem<draws_kernel<MI, NF>>(smem);
  if (e != cudaSuccess) return e;
  e = launch(overlap, draws_kernel<MI, NF>, dim3(a.K), kDrawThreads, smem, stream,
             a.partial, a.ntiles, a.W, a.P, a.B, a.K, a.gi, a.dg, a.tr, a.sj, a.sk,
             a.stamps, a.nf, a.Pg, a.pg_stride);
  if (e == cudaSuccess) ++g_draws_launches;
  return e;
}

inline cudaError_t launch_draws(const DrawArgs& a, int mi, int nf, bool overlap,
                                cudaStream_t s) {
  switch (mi) {
    case 1: return launch_draws_t<1, 2>(a, overlap, s);
    case 2: return launch_draws_t<2, 2>(a, overlap, s);
    case 3: return launch_draws_t<3, 2>(a, overlap, s);
    case 4: return launch_draws_t<4, 2>(a, overlap, s);
    case 5: return launch_draws_t<5, 2>(a, overlap, s);
    default: break;
  }
  switch (nf) {
    case 2: return launch_draws_t<6, 2>(a, overlap, s);
    case 3: return launch_draws_t<6, 3>(a, overlap, s);
    case 4: return launch_draws_t<6, 4>(a, overlap, s);
    case 5: return launch_draws_t<6, 5>(a, overlap, s);
    case 6: return launch_draws_t<6, 6>(a, overlap, s);
    case 7: return launch_draws_t<6, 7>(a, overlap, s);
    case 8: return launch_draws_t<6, 8>(a, overlap, s);
    default: return launch_draws_t<6, kRuntimeFold>(a, overlap, s);
  }
}

template <typename XT>
using RowsFn = void (*)(const XT*, const float*, long long, const XT*, int, int, int,
                        int, float*, float*, float*, long long*);

// The rows_mc_kernel instance of a register-tile shape (TK, TR, RB, TC),
// chosen by the caller (ops/blockgibbs.py:rows_mc_shape), or null.  The
// shape decides which thread sums what, never the order of a sum.
template <typename XT>
RowsFn<XT> rows_mc_instance(int tk, int tr, int rb, int tc) {
  if (tc == 2 && tk == 1 && tr == 1) {
    if (rb == 1) return rows_mc_kernel<XT, 1, 1, 1, 2>;
    if (rb == 2) return rows_mc_kernel<XT, 1, 1, 2, 2>;
  }
  if (tc != 4 || rb != 1 || (tr != 1 && tr != 2)) return nullptr;
  switch (tk * 4 + tr) {
    case 5: return rows_mc_kernel<XT, 1, 1, 1, 4>;
    case 6: return rows_mc_kernel<XT, 1, 2, 1, 4>;
    case 9: return rows_mc_kernel<XT, 2, 1, 1, 4>;
    case 10: return rows_mc_kernel<XT, 2, 2, 1, 4>;
    case 17: return rows_mc_kernel<XT, 4, 1, 1, 4>;
    case 18: return rows_mc_kernel<XT, 4, 2, 1, 4>;
    case 33: return rows_mc_kernel<XT, 8, 1, 1, 4>;
    case 34: return rows_mc_kernel<XT, 8, 2, 1, 4>;
    default: return nullptr;
  }
}

// Tiles of CTA c of a grid of G (the row tiles t = c - 1 mod G).
inline int s1_tiles(int c, int G, int ntiles) {
  const int t = (c + G - 1) % G;
  return t < ntiles ? (ntiles - 1 - t) / G + 1 : 0;
}

template <typename XT, int MI, int NF>
cudaError_t sweep1_launch(const Sweep1Args<XT>& a, int grid, cudaStream_t stream) {
  const int RP = rows_may_be_global<NF>() && a.Pg != nullptr
                     ? 0
                     : padded_stride(packed_rows(MI, NF == kRuntimeFold ? a.nf : NF));
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int xb = static_cast<int>(sizeof(XT));
  const size_t s0 = s1_layout(a.B, RP, a.rpt, xb, s1_tiles(0, grid, a.ntiles), a.nb0, true,
                              a.wb, a.cb).total;
  const size_t s1 = grid > 1 ? s1_layout(a.B, RP, a.rpt, xb, s1_tiles(1, grid, a.ntiles),
                                         a.nbr, false, a.wb, a.cb).total
                             : 0;
  const size_t smem = s0 > s1 ? s0 : s1;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = set_smem<sweep1_kernel<XT, MI, NF>>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep1_kernel<XT, MI, NF>,
                                                      kS1Threads, smem);
  if (e != cudaSuccess) return e;
  if (static_cast<long long>(per_sm) * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  sweep1_kernel<XT, MI, NF><<<grid, kS1Threads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_sweep1_launches;
  return e;
}

template <typename XT>
cudaError_t sweep1(const Sweep1Args<XT>& a, int grid, int mi, int nf, cudaStream_t s) {
  switch (mi) {
    case 1: return sweep1_launch<XT, 1, 2>(a, grid, s);
    case 2: return sweep1_launch<XT, 2, 2>(a, grid, s);
    case 3: return sweep1_launch<XT, 3, 2>(a, grid, s);
    case 4: return sweep1_launch<XT, 4, 2>(a, grid, s);
    case 5: return sweep1_launch<XT, 5, 2>(a, grid, s);
    default: break;
  }
  switch (nf) {
    case 2: return sweep1_launch<XT, 6, 2>(a, grid, s);
    case 3: return sweep1_launch<XT, 6, 3>(a, grid, s);
    case 4: return sweep1_launch<XT, 6, 4>(a, grid, s);
    case 5: return sweep1_launch<XT, 6, 5>(a, grid, s);
    case 6: return sweep1_launch<XT, 6, 6>(a, grid, s);
    case 7: return sweep1_launch<XT, 6, 7>(a, grid, s);
    case 8: return sweep1_launch<XT, 6, 8>(a, grid, s);
    default: return sweep1_launch<XT, 6, kRuntimeFold>(a, grid, s);
  }
}

// The K >= 2 sweep: per block a rows_mc_kernel launch and a draws_kernel
// launch (one CTA per chain), overlapped, then a last rows launch.
template <typename XT>
cudaError_t sweep_mc_launches(const XT* X, const float* W, const float* P, int off,
                              int nbg, int n, int rows_per_tile, const int shape[4], int B,
                              int R, int K, int mi, int nf, float* yadj, float* u,
                              float* g_out, float* dg_out, float* tr_out, float* partial,
                              long long* stamps, const float* Pg, cudaStream_t stream) {
  const long long RP = padded_stride(R);
  const int ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  const size_t xblk = static_cast<size_t>(n) * B;
  const long long m_loc = static_cast<long long>(nbg) * B;
  // one kernel for every batch size keeps chain k's sums the same whatever K
  const dim3 rows_grid(ntiles, (K + kMcChains - 1) / kMcChains);
  const int kc = K < kMcChains ? K : kMcChains;
  RowsFn<XT> rows_mc = rows_mc_instance<XT>(shape[0], shape[1], shape[2], shape[3]);
  if (rows_mc == nullptr) return cudaErrorInvalidValue;
  const int chunk_rows = kWarp * shape[1] * shape[2];
  const size_t mc_smem = rows_mc_smem(B, kc, chunk_rows, mc_stages<XT>(), sizeof(XT));
  cudaError_t e = cudaFuncSetAttribute(rows_mc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(mc_smem));
  if (e != cudaSuccess) return e;
  for (int b = 0; b <= nbg; ++b) {
    const XT* Xp = b > 0 ? X + static_cast<size_t>(off + b - 1) * xblk : nullptr;
    const XT* Xc = b < nbg ? X + static_cast<size_t>(off + b) * xblk : nullptr;
    const float* dgp = b > 0 ? dg_out + static_cast<long long>(b - 1) * B : nullptr;
    float* part = Xc != nullptr ? partial : nullptr;
    long long* sb = stamps != nullptr ? stamps + static_cast<long long>(b) * kStamps : nullptr;
    // the first launch of the sweep is ordinary: it follows pack_rows
    e = launch(b > 0, rows_mc, rows_grid, kMcThreads, mc_smem, stream, Xp, dgp, m_loc, Xc, n,
               B, rows_per_tile, K, yadj, u, part, sb);
    if (e == cudaSuccess) ++g_rows_mc_launches;
    if (e != cudaSuccess || b == nbg) return e;
    const long long lb = static_cast<long long>(b) * B;
    const DrawArgs a{partial, ntiles,
                     W + static_cast<size_t>(off + b) * B * B,
                     P + static_cast<size_t>(b) * B * R * K, B, R, K,
                     g_out + lb, dg_out + lb, tr_out + lb, 1, m_loc, sb, nf,
                     Pg == nullptr ? nullptr : Pg + lb * RP, m_loc * RP};
    e = launch_draws(a, mi, nf, true, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace hb

extern "C" {

const char* hb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches of sweep1_kernel, rows_mc_kernel and draws_kernel since the
// last reset.
void hb_launch_counts(long long* sweep1, long long* rows_mc, long long* draws) {
  *sweep1 = hb::g_sweep1_launches;
  *rows_mc = hb::g_rows_mc_launches;
  *draws = hb::g_draws_launches;
}

void hb_reset_launch_counts() {
  hb::g_sweep1_launches = hb::g_rows_mc_launches = hb::g_draws_launches = 0;
}

// One block of B sequential draws for K chains.
//   r0t (K, B) = X_b' yadj per chain; W (B, B); P (B, R, K)
//   dg, track (B, K) outputs.  Pg (null, or the rows (K, B,
//   padded_stride(R)) SNP-major): the draws read them there.
int hb_block_draws(const float* r0t, const float* W, const float* P, int B,
                   int R, int K, int mi, int nf, float* dg, float* track,
                   const float* Pg, void* stream) {
  if (!hb::shapes_ok(B, R, K, mi, nf) || (Pg != nullptr && !hb::global_rows_ok(mi, nf)))
    return cudaErrorInvalidValue;
  const hb::DrawArgs a{r0t, 1, W, P, B, R, K, nullptr, dg, track, K, 1, nullptr, nf, Pg,
                       static_cast<long long>(B) * hb::padded_stride(R)};
  return hb::launch_draws(a, mi, nf, false, static_cast<cudaStream_t>(stream));
}

// Fused K-chain sweep over blocks [off, off + nbg) of X (nb_tot, n, B) and
// W (nb_tot, B, B).  P (nbg, B, R, K) packed rows; yadj, u (K, n) updated in
// place; g_out, dg_out, track (K, nbg * B) outputs; partial is scratch of
// ceil(n / rows_per_tile) * K * B floats.
// K = 1: one sweep1_kernel launch of `grid` CTAs; C (nb_tot, B, B) the
// cross-Grams of consecutive blocks, C[k] = X_k' X_{k-1}, indexed globally
// like W; nb0 and nbr are the X tile buffers of the drawer's and the other
// CTAs' tiles (3, 1 or 0), wb and cb the drawer's buffers of W and C
// (ops/blockgibbs.py:sweep1_plan), flags (1 + ceil(n / rows_per_tile)
// unsigned, 16-byte aligned) the launch's flags, whose values this sweep
// takes from epoch + 1 to epoch + nbg; partial holds 2 ceil(n /
// rows_per_tile) B floats.
// K >= 2: (tk, tr, rb, tc) is rows_mc_kernel's register-tile shape
// (rows_mc_instance).
// stamps (measurement only; null in use): nbg + 1 records of hb::kStamps.
// Pg (null, or the packed rows (K, nbg * B, padded_stride(R)) SNP-major):
// the draws read the rows there instead of staging P in shared memory.
int hb_sweep_mc(const void* X, int x_int8, const float* W, const float* P,
                int off, int nbg, int n, int rows_per_tile, int tk, int tr,
                int rb, int tc, int B, int R, int K, int mi, int nf, float* yadj,
                float* u, float* g_out, float* dg_out, float* track, float* partial,
                const float* C, unsigned* flags, unsigned epoch, int grid, int nb0, int nbr,
                int wb, int cb, long long* stamps, const float* Pg, void* stream) {
  if (!hb::shapes_ok(B, R, K, mi, nf) || n <= 0 || rows_per_tile <= 0 ||
      off < 0 || nbg < 0 || (Pg != nullptr && !hb::global_rows_ok(mi, nf)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shape[4] = {tk, tr, rb, tc};
  if (K == 1) {
    const auto buffers_ok = [](int nb) { return nb == 0 || nb == 1 || nb == 3; };
    if (grid < 1 || flags == nullptr || C == nullptr || !buffers_ok(nb0) || !buffers_ok(nbr) ||
        wb < 1 || wb > 2 || cb < 0 || cb > 1)
      return cudaErrorInvalidValue;
    if (nbg == 0) return cudaSuccess;   // nothing to sweep
    const int ntiles = (n + rows_per_tile - 1) / rows_per_tile;
    if (x_int8) {
      const hb::Sweep1Args<int8_t> a{static_cast<const int8_t*>(X), W, C, P, off, nbg, n, B,
                                     rows_per_tile, ntiles, yadj, u, g_out, dg_out, track,
                                     partial, flags, epoch, nb0, nbr, wb, cb, stamps, nf, Pg};
      return hb::sweep1(a, grid, mi, nf, s);
    }
    const hb::Sweep1Args<float> a{static_cast<const float*>(X), W, C, P, off, nbg, n, B,
                                  rows_per_tile, ntiles, yadj, u, g_out, dg_out, track,
                                  partial, flags, epoch, nb0, nbr, wb, cb, stamps, nf, Pg};
    return hb::sweep1(a, grid, mi, nf, s);
  }
  if (x_int8)
    return hb::sweep_mc_launches(static_cast<const int8_t*>(X), W, P, off, nbg, n,
                                 rows_per_tile, shape, B, R, K, mi, nf, yadj, u, g_out,
                                 dg_out, track, partial, stamps, Pg, s);
  return hb::sweep_mc_launches(static_cast<const float*>(X), W, P, off, nbg, n,
                               rows_per_tile, shape, B, R, K, mi, nf, yadj, u, g_out,
                               dg_out, track, partial, stamps, Pg, s);
}

}  // extern "C"

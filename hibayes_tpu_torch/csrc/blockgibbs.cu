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
// memory (an int8 X block is 6.4 MB at n = 50,000) and CTAs run in no order,
// so one sweep is a sequence of launches on one stream, two per SNP block:
//
//   rows_kernel   (K = 1) grid over row tiles of n, about one tile per SM
//                 (the caller picks the tile size).  Applies the previous
//                 block's effect changes (yadj += X_{b-1} dg, u -= X_{b-1} dg)
//                 to its rows, then writes its partial X_b' yadj (K, B).
//                 Bound by device-memory latency: it streams X_{b-1}
//                 (usually still in the 50 MB L2) and X_b once each, 16 bytes
//                 of f32 or 4 bytes of int8 per lane per row, coalesced, four
//                 rows in flight per warp, and each warp makes only a few
//                 round trips to memory, so every SM must take part.
//   rows_mc_kernel  (K >= 2, the port of _kernel_mc's two products) the
//                 same work for K chains that share X, X read once for all
//                 chains.  Its bound is X's bytes at small K (an int8 block
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
//
// At K >= 2 every launch of a sweep but the first overlaps the one before
// it (programmatic dependent launch, pdl.cuh): a rows launch puts its
// first X chunks in flight, a draws launch loads W_b and the packed rows,
// and only then does each wait for the launch before it and read dg, yadj
// or the partials.  A rows launch lets the next draws launch start at
// once, so W_b arrives while the draws before still run their chain (when
// device memory is idle); a draws launch lets the next rows launch start
// once its own wait is over.  At K = 1 the launches are ordinary: a
// rows_kernel CTA takes all of an SM's registers, so the draws launch
// could not start beside it, and overlap measured slower (PERF.md).
//
// A last rows launch applies the final block's changes.  X and W are
// indexed by the GLOBAL block off + b; the packed rows and outputs by the
// local b (sweep_mc_tc reads W by the local block, a TPU-side fault this
// port does not copy).  Any n is taken: the ragged last tile is masked here.
//
// With a stamps buffer (measurement only) the first CTA of each launch
// records %globaltimer at its stages (hb_sweep_mc).

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"
#include "pdl.cuh"

namespace hb {

constexpr int kDrawWarps = 8;
constexpr int kDrawThreads = kWarp * kDrawWarps;
constexpr int kRowWarps = 32;
constexpr int kRowThreads = kWarp * kRowWarps;
constexpr int kRowUnroll = 4;   // rows in flight per warp (8 spills at 64 registers)

// rows_mc_kernel: 8 warps; a CTA serves up to kMcChains chains (grid.y =
// ceil(K / kMcChains)).
constexpr int kMcWarps = 8;
constexpr int kMcThreads = kWarp * kMcWarps;
constexpr int kMcChains = 64;

// Stamps per block in the stamps buffer, %globaltimer ns: rows launch
// (start, after its wait, end), draws launch (start, W and P loaded, after
// its wait, partials summed, draws done); then clock64 of rows_mc_kernel's
// first CTA: after its wait, and through its first chunk after the first
// barrier, after the next chunk's copies are issued, after the residual
// update, after the second barrier and after the partials; at its end.
constexpr int kStamps = 16;

// Launches of each kernel, counted where it is launched (hb_launch_counts).
long long g_rows_launches = 0;
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

__device__ __forceinline__ void stamp(long long* s, int i) {
  if (s != nullptr) s[i] = global_ns();
}

__device__ __forceinline__ void stamp_clock(long long* s, int i) {
  if (s != nullptr) s[i] = clock64();
}

// grid (ntiles, K), kRowThreads threads; tile t holds rows [t * rows_per_tile,
// (t + 1) * rows_per_tile) of n.  A warp takes kRowUnroll rows at a time
// (all their loads in flight together); lane l owns columns 4l .. 4l+3.
// Xprev == nullptr skips the residual update, Xcur == nullptr the partials.
// Launched as an ordinary launch (no overlap: a CTA takes all of an SM's
// registers, so no draws CTA could start beside it).
template <typename XT>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const XT* __restrict__ Xprev, const float* __restrict__ dgprev,
            long long dg_stride, const XT* __restrict__ Xcur, int n, int B,
            int rows_per_tile, float* __restrict__ yadj,
            float* __restrict__ u, float* __restrict__ partial, long long* stamps) {
  __shared__ float red[kRowWarps][kMaxBlock];
  long long* st = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 ? stamps : nullptr;
  stamp(st, 0);
  stamp(st, 1);
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int K = gridDim.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = 4 * lane;
  const bool owns = c0 < B;

  float dgp[4] = {0.f, 0.f, 0.f, 0.f};
  if (Xprev != nullptr && owns) {
    for (int q = 0; q < 4; ++q) dgp[q] = dgprev[k * dg_stride + c0 + q];
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float* yk = yadj + static_cast<long long>(k) * n;
  float* uk = u + static_cast<long long>(k) * n;
  const int row_end = min(n, (tile + 1) * rows_per_tile);
  for (int row0 = tile * rows_per_tile + warp; row0 < row_end;
       row0 += kRowWarps * kRowUnroll) {
    float ya[kRowUnroll], ua[kRowUnroll], part[kRowUnroll], xc[kRowUnroll][4];
#pragma unroll
    for (int v = 0; v < kRowUnroll; ++v) {
      const int row = row0 + v * kRowWarps;
      const bool ok = row < row_end;
      ya[v] = ok ? yk[row] : 0.f;
      ua[v] = ok && Xprev != nullptr ? uk[row] : 0.f;
      part[v] = 0.f;
      for (int q = 0; q < 4; ++q) xc[v][q] = 0.f;
      if (ok && owns) {
        const size_t at = static_cast<size_t>(row) * B + c0;
        if (Xprev != nullptr) {
          float xp[4];
          load4(Xprev + at, xp);
          part[v] = xp[0] * dgp[0] + xp[1] * dgp[1] + xp[2] * dgp[2] + xp[3] * dgp[3];
        }
        if (Xcur != nullptr) load4(Xcur + at, xc[v]);
      }
    }
    if (Xprev != nullptr) {
      for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int v = 0; v < kRowUnroll; ++v)
          part[v] += __shfl_down_sync(0xffffffffu, part[v], o);
      }
#pragma unroll
      for (int v = 0; v < kRowUnroll; ++v) {
        const int row = row0 + v * kRowWarps;
        const float delta = __shfl_sync(0xffffffffu, part[v], 0);
        ya[v] += delta;
        if (lane == 0 && row < row_end) {
          yk[row] = ya[v];
          uk[row] = ua[v] - delta;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kRowUnroll; ++v)
      for (int q = 0; q < 4; ++q) acc[q] += xc[v][q] * ya[v];
  }
  if (partial != nullptr) {
    if (owns) {
      for (int q = 0; q < 4; ++q) red[warp][c0 + q] = acc[q];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < B; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < kRowWarps; ++w) s += red[w][c];
      partial[(static_cast<long long>(tile) * K + k) * B + c] = s;
    }
  }
  stamp(st, 2);
}


// ---------------------------------------------------------------------------
// rows_mc_kernel
// ---------------------------------------------------------------------------

// Chunks of X a rows_mc_kernel CTA keeps in flight: int8 chunks are small.
template <typename XT>
__host__ __device__ constexpr int mc_stages() { return sizeof(XT) == 1 ? 3 : 2; }

// Four int8 values of one 32-bit word as exact floats: each byte, its sign
// bit flipped, becomes the low mantissa byte of 2^23 + 128 + x (a byte
// permute), and one add takes 2^23 + 128 away.  Two full-rate instructions
// in place of a quarter-rate conversion.
__device__ __forceinline__ float byte_float(unsigned w, int i) {
  return __int_as_float(static_cast<int>(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                                     0x7440u | i))) - 8388736.f;
}

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

inline size_t draws_smem(int B, int R) {
  return sizeof(float) * (static_cast<size_t>(B) * B + static_cast<size_t>(B) * R +
                          static_cast<size_t>(kDrawWarps) * B);
}

// grid K (one CTA per chain), kDrawThreads threads, dynamic shared memory
// draws_smem(B, R).  partial (ntiles, K, B) holds X_b' yadj in row-tile
// pieces: warp w sums the chain's tiles w, w + 8, ... (lane l columns
// 4l .. 4l+3) and warp 0 adds the eight sums in warp order, a fixed order.
// P (B, R, K) holds the packed rows of this block; W (B, B) its Gram.
// Outputs (any may be null) go to out[j * sj + k * sk].  W and P are loaded
// before the wait for the launch before (none of the sweep writes them).
template <int MI, int NF>
__global__ void __launch_bounds__(kDrawThreads)
draws_kernel(const float* __restrict__ partial, int ntiles,
             const float* __restrict__ W, const float* __restrict__ P, int B,
             int K, float* gi_out, float* dg_out, float* tr_out, long long sj,
             long long sk, long long* stamps) {
  constexpr int R = packed_rows(MI, NF);
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  float* Ws = smem;        // B * B
  float* Ps = Ws + B * B;  // B * R
  float* red = Ps + B * R; // kDrawWarps * B
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
  for (int i = threadIdx.x; i < B * R; i += blockDim.x)
    Ps[i] = P[static_cast<long long>(i) * K + k];
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
    const int i = lane + kWarp * s;
    float acc = 0.f;
    if (i < B)
      for (int w = 0; w < kDrawWarps; ++w) acc += red[w * B + i];
    r[s] = acc;
    gi[s] = dg[s] = tr[s] = 0.f;
  }
  stamp(st, 6);
  warp_block_draws<MI, NF>(B, Ws, Ps, r, gi, dg, tr);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + kWarp * s;
    if (j >= B) continue;
    const long long o = j * sj + k * sk;
    if (gi_out != nullptr) gi_out[o] = gi[s];
    if (dg_out != nullptr) dg_out[o] = dg[s];
    if (tr_out != nullptr) tr_out[o] = tr[s];
  }
  stamp(st, 7);
}

inline bool shapes_ok(int B, int R, int K, int mi, int nf) {
  return B > 0 && B <= kMaxBlock && B % 4 == 0 && K > 0 && mi >= 1 &&
         mi <= 6 && nf >= 2 && nf <= kMaxFold && R == packed_rows(mi, nf);
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
  const size_t smem = draws_smem(a.B, a.R);
  cudaError_t e = set_smem<draws_kernel<MI, NF>>(smem);
  if (e != cudaSuccess) return e;
  e = launch(overlap, draws_kernel<MI, NF>, dim3(a.K), kDrawThreads, smem, stream,
             a.partial, a.ntiles, a.W, a.P, a.B, a.K, a.gi, a.dg, a.tr, a.sj, a.sk,
             a.stamps);
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
    default: return cudaErrorInvalidValue;
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

template <typename XT>
cudaError_t sweep(const XT* X, const float* W, const float* P, int off,
                  int nbg, int n, int rows_per_tile, const int shape[4], int B,
                  int R, int K, int mi, int nf, float* yadj, float* u, float* g_out,
                  float* dg_out, float* tr_out, float* partial, long long* stamps,
                  cudaStream_t stream) {
  const int ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  const size_t xblk = static_cast<size_t>(n) * B;
  const long long m_loc = static_cast<long long>(nbg) * B;
  // K = 1: the single-chain rows kernel; K >= 2: the K-chain one, which
  // reads each X tile once for all chains.  One kernel for every batch size
  // keeps chain k's sums the same whatever K.
  const bool mc = K > 1;
  const dim3 rows_grid(ntiles, mc ? (K + kMcChains - 1) / kMcChains : 1);
  const int kc = K < kMcChains ? K : kMcChains;
  RowsFn<XT> rows_mc = mc ? rows_mc_instance<XT>(shape[0], shape[1], shape[2], shape[3])
                          : nullptr;
  if (mc && rows_mc == nullptr) return cudaErrorInvalidValue;
  const int chunk_rows = kWarp * shape[1] * shape[2];
  const size_t mc_smem =
      mc ? rows_mc_smem(B, kc, chunk_rows, mc_stages<XT>(), sizeof(XT)) : 0;
  if (mc) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_mc, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(mc_smem));
    if (e != cudaSuccess) return e;
  }
  for (int b = 0; b <= nbg; ++b) {
    const XT* Xp = b > 0 ? X + static_cast<size_t>(off + b - 1) * xblk : nullptr;
    const XT* Xc = b < nbg ? X + static_cast<size_t>(off + b) * xblk : nullptr;
    const float* dgp = b > 0 ? dg_out + static_cast<long long>(b - 1) * B : nullptr;
    float* part = Xc != nullptr ? partial : nullptr;
    long long* sb = stamps != nullptr ? stamps + static_cast<long long>(b) * kStamps : nullptr;
    // the first launch of the sweep is ordinary: it follows pack_rows.  At
    // K = 1 every launch is: a rows CTA takes all of an SM's registers, so
    // no draws CTA could start beside it, and overlapped launches measured
    // slower there (PERF.md)
    const bool overlap = mc && b > 0;
    cudaError_t e =
        mc ? launch(overlap, rows_mc, rows_grid, kMcThreads, mc_smem, stream, Xp, dgp, m_loc,
                    Xc, n, B, rows_per_tile, K, yadj, u, part, sb)
           : launch(false, rows_kernel<XT>, rows_grid, kRowThreads, 0, stream, Xp, dgp,
                    m_loc, Xc, n, B, rows_per_tile, yadj, u, part, sb);
    if (e == cudaSuccess) ++(mc ? g_rows_mc_launches : g_rows_launches);
    if (e != cudaSuccess || b == nbg) return e;
    const long long lb = static_cast<long long>(b) * B;
    const DrawArgs a{partial, ntiles,
                     W + static_cast<size_t>(off + b) * B * B,
                     P + static_cast<size_t>(b) * B * R * K, B, R, K,
                     g_out + lb, dg_out + lb, tr_out + lb, 1, m_loc, sb};
    e = launch_draws(a, mi, nf, mc, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace hb

extern "C" {

const char* hb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches of rows_kernel, rows_mc_kernel and draws_kernel since the last
// reset.
void hb_launch_counts(long long* rows, long long* rows_mc, long long* draws) {
  *rows = hb::g_rows_launches;
  *rows_mc = hb::g_rows_mc_launches;
  *draws = hb::g_draws_launches;
}

void hb_reset_launch_counts() {
  hb::g_rows_launches = hb::g_rows_mc_launches = hb::g_draws_launches = 0;
}

// One block of B sequential draws for K chains.
//   r0t (K, B) = X_b' yadj per chain; W (B, B); P (B, R, K)
//   dg, track (B, K) outputs.
int hb_block_draws(const float* r0t, const float* W, const float* P, int B,
                   int R, int K, int mi, int nf, float* dg, float* track,
                   void* stream) {
  if (!hb::shapes_ok(B, R, K, mi, nf)) return cudaErrorInvalidValue;
  const hb::DrawArgs a{r0t, 1, W, P, B, R, K, nullptr, dg, track, K, 1, nullptr};
  return hb::launch_draws(a, mi, nf, false, static_cast<cudaStream_t>(stream));
}

// Fused K-chain sweep over blocks [off, off + nbg) of X (nb_tot, n, B) and
// W (nb_tot, B, B).  P (nbg, B, R, K) packed rows; yadj, u (K, n) updated in
// place; g_out, dg_out, track (K, nbg * B) outputs; partial is scratch of
// ceil(n / rows_per_tile) * K * B floats.  At K >= 2, (tk, tr, rb, tc) is
// rows_mc_kernel's register-tile shape (rows_mc_instance).  stamps
// (measurement only; null in use): nbg + 1 records of hb::kStamps
// %globaltimer values.
int hb_sweep_mc(const void* X, int x_int8, const float* W, const float* P,
                int off, int nbg, int n, int rows_per_tile, int tk, int tr,
                int rb, int tc, int B, int R, int K, int mi, int nf, float* yadj,
                float* u, float* g_out, float* dg_out, float* track, float* partial,
                long long* stamps, void* stream) {
  if (!hb::shapes_ok(B, R, K, mi, nf) || n <= 0 || rows_per_tile <= 0 ||
      off < 0 || nbg < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shape[4] = {tk, tr, rb, tc};
  if (x_int8)
    return hb::sweep(static_cast<const int8_t*>(X), W, P, off, nbg, n,
                     rows_per_tile, shape, B, R, K, mi, nf, yadj, u, g_out, dg_out,
                     track, partial, stamps, s);
  return hb::sweep(static_cast<const float*>(X), W, P, off, nbg, n,
                   rows_per_tile, shape, B, R, K, mi, nf, yadj, u, g_out, dg_out,
                   track, partial, stamps, s);
}

}  // extern "C"

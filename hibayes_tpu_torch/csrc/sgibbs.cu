// Hopper kernels of the summary-level (sbrm) blocked-Gibbs sweep.
//
// Built with nvcc into its own shared library with a plain C interface
// (hibayes_tpu_torch/ops/build.py) and called through ctypes
// (hibayes_tpu_torch/ops/blockgibbs.py).  Every entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
//
// They replace the TPU kernels of hibayes_tpu/ops/blockgibbs.py:
//   hb_sweep_s_segment <- _kernel_s / sweep_s_segment        (:1141-1254)
//                         at K = 1, and for K >= 2 chains the segment
//                         sweep sweep_s_segment_t (:1325-1362), whose draws
//                         are _kernel_s_block_t (:1264-1322)
//   hb_sweep_s_tiled   <- _kernel_s_tiled / sweep_s_tiled     (:1635-1792)
//
// The chain state is r_hat, the adjusted X'y.  Per block b of B SNPs the
// TPU kernels draw B effects against the Gram rows n * LD[block, block],
// then add n * LD[:, block] dg to r_hat (SBayesD.cpp:264-267), carrying
// r_hat in VMEM across an in-order grid.  CTAs run in no order here.
//
// The dense segment sweep is one C loop on one stream, two launches per
// block:
//   s_draws_kernel   one CTA per 8 chains: loads the B x B Gram block scaled
//                    by n and its chains' packed rows into shared memory,
//                    then warp w runs chain w's B dependent draws
//                    (draws.cuh).
//   seg_update_kernel  r_seg[k, i] += n sum_j LD[i, bB + j] dg[k, j] for
//                    every row i of the segment and every chain k: many
//                    CTAs, four rows per warp, each CTA owning distinct
//                    rows, so no atomics and a fixed summation order; the
//                    LD column block is read once for all chains.
// Every launch but the first may start while the one before it still runs
// (programmatic dependent launch, pdl.cuh): each first loads what no
// earlier launch of the sweep writes (the Gram block, the packed rows, the
// segment's LD rows), then waits, and only then reads r_hat or dg.  A draw
// launch lets its successor start once its own wait is over; an update
// launch at once.
//
// The tiled sweep is one persistent launch (tiled_sweep_kernel): a grid no
// larger than the CTAs that fit on the card at once.  CTA 0, the drawer,
// walks the tile rows in order: one warp runs row i's B guarded draws,
// dg is published (a release flag per row), and the drawer itself adds
// row i's contribution to block i + 1, the only one row i + 1's draws wait
// for; while row i draws, its other warps stage row i + 1's diagonal tile
// and packed rows and the tile (i, i + 1) in shared memory and read r_hat
// of block i + 1 once its other contributions have landed.  The other CTAs
// apply the other valid slots of each row, r_hat[block cols[i, k]] += n
// tiles[i, k]^T dg, each once the row's dg is published.  An integer
// counter per target block makes the contributions to a block land in
// sweep order, so every sum is the same run to run; the order comes from a
// schedule the host builds once from cols and valid
// (ops/blockgibbs.py:tiled_schedule), and the counters run on across
// sweeps (an epoch), so nothing is reset between sweeps.
//
// What bounds them on this card: not device memory (the tiled sweep of the
// m = 500,000 band moves 2.34 GB, 0.70 ms at 3.35 TB/s; a dense segment of
// m = 32,768 4.3 GB, 1.28 ms) but the dependent draw chain of each block:
// B draws in one warp, 128 a block, which no amount of parallel hardware
// shortens (its latency alone: hb_chain_latency, PERF.md).  The segment
// sweep hides each launch's loads behind the chain before it; the tiled
// sweep also takes the launches and every hand-off off the chain, which
// leaves per row the chain, the product of one tile in shared memory and
// three barriers.
//
// The packed rows are read in the (R, m) layout that pack_rows returns and
// transposed into shared memory, each SNP's rows at padded_stride (draws.cuh).
//
// Rounding: the TPU kernels scale inside the draw, dg * n * w (:1179,
// :1693); here a draw adds dg * (n * w), with n * w formed once on load
// (segment sweep) or where the Gram row is read (tiled sweep): the same
// float32 product.
// The update adds n * (sum_j w_ij dg_j), as the TPU kernels do (:1192,
// :1709), with the sum in another order.  All in float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"
#include "pdl.cuh"

namespace hb {

constexpr int kSDrawThreads = 256;   // 8 warps load the Gram block; one per chain draws
constexpr int kSChainsPerCta = kSDrawThreads / kWarp;
constexpr int kUpdWarps = 8;
constexpr int kUpdThreads = kWarp * kUpdWarps;
constexpr int kUpdRows = 4;          // rows in flight per warp

// Launches of each kernel, counted where it is launched (hb_s_launch_counts).
long long g_seg_draws = 0, g_seg_update = 0, g_tiled_sweep = 0;

// One block of B draws for each of K chains.  W: the block's B x B Gram
// rows with row stride ldw (unscaled LD), scaled by n on load.  P: packed
// rows (K, R, m); the block's SNPs are columns col0 .. col0 + B - 1, as are
// its entries of r, dg and tr (K, m).  CTA c serves chains 8c .. 8c + 7,
// warp w chain 8c + w.
template <int MI, int NF>
__global__ void __launch_bounds__(kSDrawThreads)
s_draws_kernel(const float* __restrict__ W, long long ldw, float n,
               const float* __restrict__ P, long long m, long long col0, int B,
               int K, const float* __restrict__ r, float* __restrict__ dg_out,
               float* __restrict__ tr_out) {
  constexpr int R = packed_rows(MI, NF);
  constexpr int RP = padded_stride(R);
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.x * kSChainsPerCta;
  const int kc = min(kSChainsPerCta, K - k0);
  float* Ws = smem;           // B * B
  float* Ps = Ws + B * B;     // kc * B * RP, chain-major, SNP-major within
  const int B4 = B / 4;
  for (int i = threadIdx.x; i < B * B4; i += blockDim.x) {
    const int a = i / B4, c = 4 * (i - a * B4);
    float4 w = *reinterpret_cast<const float4*>(W + a * ldw + c);
    w.x *= n; w.y *= n; w.z *= n; w.w *= n;
    *reinterpret_cast<float4*>(Ws + a * B + c) = w;
  }
  for (int i = threadIdx.x; i < kc * B * R; i += blockDim.x) {
    const int kk = i / (B * R), rest = i - kk * B * R;
    const int row = rest / B, j = rest - row * B;
    Ps[kk * B * RP + j * RP + row] =
        P[(static_cast<long long>(k0 + kk) * R + row) * m + col0 + j];
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  if (warp >= kc) return;
  wait_previous();   // the previous update of r is visible from here
  release_next();
  const int lane = threadIdx.x % kWarp;
  const long long kb = static_cast<long long>(k0 + warp) * m + col0;
  float rr[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = kSlots * lane + s;
    rr[s] = i < B ? r[kb + i] : 0.f;
    gi[s] = dg[s] = tr[s] = 0.f;
  }
  warp_block_draws<MI, NF>(B, Ws, Ps + warp * B * RP, rr, gi, dg, tr);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = kSlots * lane + s;
    if (j < B) {
      dg_out[kb + j] = dg[s];
      tr_out[kb + j] = tr[s];
    }
  }
}

// r[k, i] += n * sum_j LD[i, col0 + j] dg[k, col0 + j] for i in [0, mc) and
// each chain k < K (r, dg (K, mc)).  Warp w of CTA c takes rows
// (c * kUpdWarps + w) * kUpdRows + v, v < kUpdRows, all loads in flight
// together (before the wait for the draws) and kept in registers for every
// chain; lane l owns columns 4l .. 4l + 3 (B <= 128).  A chain's sums do
// not depend on K.
__global__ void __launch_bounds__(kUpdThreads)
seg_update_kernel(const float* __restrict__ LD, long long mc, long long col0,
                  int B, int K, float n, const float* __restrict__ dg,
                  float* __restrict__ r) {
  release_next();
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = 4 * lane;
  const bool owns = c0 < B;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kUpdWarps + warp) * kUpdRows;
  float4 x[kUpdRows];
#pragma unroll
  for (int v = 0; v < kUpdRows; ++v) {
    x[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (owns && row0 + v < mc)
      x[v] = *reinterpret_cast<const float4*>(LD + (row0 + v) * mc + col0 + c0);
  }
  wait_previous();   // dg of this block is visible from here
  for (int k = 0; k < K; ++k) {
    const long long kb = static_cast<long long>(k) * mc;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (owns) d = *reinterpret_cast<const float4*>(dg + kb + col0 + c0);
    float part[kUpdRows];
#pragma unroll
    for (int v = 0; v < kUpdRows; ++v)
      part[v] = x[v].x * d.x + x[v].y * d.y + x[v].z * d.z + x[v].w * d.w;
    for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int v = 0; v < kUpdRows; ++v)
        part[v] += __shfl_down_sync(0xffffffffu, part[v], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int v = 0; v < kUpdRows; ++v)
        if (row0 + v < mc) r[kb + row0 + v] += n * part[v];
    }
  }
}

inline bool block_ok(int B, int mi, int nf) {
  return B > 0 && B <= kMaxBlock && B % 4 == 0 && mi >= 1 && mi <= 6 &&
         nf >= 2 && nf <= kMaxFold;
}

// Shared memory of s_draws_kernel for kc chains per CTA (into *smem), set
// as the kernel's limit.
template <int MI, int NF>
cudaError_t set_draw_smem(int B, int kc, size_t* smem) {
  *smem = sizeof(float) * static_cast<size_t>(B) *
          (B + static_cast<size_t>(kc) * padded_stride(packed_rows(MI, NF)));
  return cudaFuncSetAttribute(s_draws_kernel<MI, NF>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

struct SegArgs {
  const float* LD;
  const float* P;
  int mc, B, K;
  float n;
  float *r, *dg, *tr;
};

template <int MI, int NF, bool GUARD>
cudaError_t seg_sweep(const SegArgs& a, cudaStream_t stream) {
  size_t smem;
  cudaError_t e = set_draw_smem<MI, NF>(
      a.B, a.K < kSChainsPerCta ? a.K : kSChainsPerCta, &smem);
  if (e != cudaSuccess) return e;
  const long long mc = a.mc;
  const int draw_grid = (a.K + kSChainsPerCta - 1) / kSChainsPerCta;
  const int upd_grid = static_cast<int>((mc + kUpdWarps * kUpdRows - 1) / (kUpdWarps * kUpdRows));
  for (long long col0 = 0; col0 < mc; col0 += a.B) {
    e = launch(col0 > 0, s_draws_kernel<MI, NF>, draw_grid, kSDrawThreads, smem,
               stream, a.LD + col0 * mc + col0, mc, a.n, a.P, mc, col0, a.B, a.K,
               static_cast<const float*>(a.r), a.dg, a.tr);
    if (e != cudaSuccess) return e;
    ++g_seg_draws;
    e = launch(true, seg_update_kernel, upd_grid, kUpdThreads, 0, stream, a.LD, mc,
               col0, a.B, a.K, a.n, static_cast<const float*>(a.dg), a.r);
    if (e != cudaSuccess) return e;
    ++g_seg_update;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// the tiled sweep: one persistent launch
// ---------------------------------------------------------------------------

constexpr int kTiledWarps = 8;
constexpr int kTiledThreads = kWarp * kTiledWarps;
constexpr int kTileRows = kMaxBlock / kTiledWarps;   // rows of a tile per warp

// Inputs of the persistent tiled sweep.  The schedule (built on the host,
// ops/blockgibbs.py:tiled_schedule): need[i] contributions reach block i
// from rows before i; nxt[i] is row i's slot whose block is i + 1 (the
// drawer applies it), or -1; items (row, slot, target block, sequence
// number) are the other valid slots, row by row; total[t] contributions
// reach block t in a sweep.  cnt[t] counts the contributions that have
// landed on block t and flags[i] says that row i's dg is published; both
// run on across sweeps: sweep `epoch` starts with cnt[t] = epoch total[t]
// and publishes flags[i] = epoch + 1.
struct TiledArgs {
  const float* tiles;
  int nbr, K, B;
  float n, vary;
  const float* P;
  float *r_hat, *dg, *tr;
  int* nrej;
  const int* need;
  const int* nxt;
  const int4* items;
  int nitems;
  const int* total;
  unsigned* cnt;
  unsigned* flags;
  unsigned epoch;
  int stage_next;     // the drawer stages tile (i, i + 1) in shared memory
  long long* stamps;  // measurement only (null in use)
};

// The tile rows a = warp + 8 t of T (B x B, row-major; shared or global
// memory), columns 4 lane .. 4 lane + 3, zeros outside.
__device__ __forceinline__ void tile_rows(const float* T, int B, float4 x[kTileRows]) {
  const int warp = threadIdx.x / kWarp;
  const int c0 = 4 * (threadIdx.x % kWarp);
#pragma unroll
  for (int t = 0; t < kTileRows; ++t) {
    const int a = warp + kTiledWarps * t;
    x[t] = (c0 < B && a < B) ? *reinterpret_cast<const float4*>(T + a * B + c0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Warp w's partial sums over its tile rows a = w, w + 8, ... of
// sum_a T[a, c] dg[a] (columns 4 lane .. 4 lane + 3) into red; the eight
// are added in warp order after a barrier, so whoever applies a
// contribution rounds it alike.  dgs holds dg of the tile's row.
__device__ __forceinline__ void tile_partial(const float4 x[kTileRows], const float* dgs,
                                             float* red, int B) {
  const int warp = threadIdx.x / kWarp;
  const int c0 = 4 * (threadIdx.x % kWarp);
  if (c0 < B) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int row = warp + kTiledWarps * r;
      const float da = row < B ? dgs[row] : 0.f;
      acc[0] += x[r].x * da; acc[1] += x[r].y * da; acc[2] += x[r].z * da; acc[3] += x[r].w * da;
    }
    for (int q = 0; q < 4; ++q) red[warp * kMaxBlock + c0 + q] = acc[q];
  }
}

__device__ __forceinline__ float tile_sum(const float* red, int c) {
  float s = 0.f;
  for (int w = 0; w < kTiledWarps; ++w) s += red[w * kMaxBlock + c];
  return s;
}

// r_hat[t * B + c] += n * sum_a T[a, c] dg[a] for the contribution with
// sequence number seq on block t, once every earlier contribution to block
// t has landed; then the count is published.  All threads of the CTA call
// it.
__device__ __forceinline__ void apply_tile(const TiledArgs& a, const float4 x[kTileRows],
                                           const float* dgs, float* red, int t,
                                           unsigned seq) {
  const int B = a.B;
  tile_partial(x, dgs, red, B);
  const unsigned base = a.epoch * static_cast<unsigned>(a.total[t]);
  if (threadIdx.x == 0) await(a.cnt + t, base + seq);
  __syncthreads();   // red complete; the earlier contributions to t landed
  if (threadIdx.x < B) {
    float* p = a.r_hat + static_cast<long long>(t) * B + threadIdx.x;
    __stcg(p, __ldcg(p) + a.n * tile_sum(red, threadIdx.x));
  }
  __syncthreads();
  if (threadIdx.x == 0) publish(a.cnt + t, base + seq + 1);
}

// Row i's packed rows into Pd (SNP-major, padded_stride(R) floats a SNP)
// by threads t0, t0 + nt, ...: cp.async, one commit group.
template <int R>
__device__ __forceinline__ void stage_rows(const TiledArgs& a, int i, float* Pd, int t0,
                                           int nt) {
  constexpr int RP = padded_stride(R);
  const int B = a.B;
  const long long m = static_cast<long long>(a.nbr) * B;
  for (int e = t0; e < B * R; e += nt) {
    const int row = e / B, j = e - row * B;
    cp_async4(Pd + j * RP + row, a.P + row * m + static_cast<long long>(i) * B + j);
  }
  cp_async_commit();
}

// Floats before the shared memory every CTA uses: the drawer's three
// mbarriers (the two diagonal-tile buffers, the tile (i, i + 1)).
constexpr int kBarFloats = 8;

// Shared memory of the tiled sweep in floats: the mbarriers, red (8 x
// kMaxBlock), dgs, and the drawer's r_hat of the row it draws and of the
// next (kMaxBlock each), for every CTA; the drawer's two diagonal tiles,
// the tile (i, i + 1) when staged, and two rows' packed rows (R rows a SNP
// at padded_stride(R)).
inline size_t tiled_smem(int B, int R, bool stage_next) {
  return sizeof(float) * (kBarFloats + (kTiledWarps + 3) * kMaxBlock +
                          static_cast<size_t>(B) * B * (stage_next ? 3 : 2) +
                          2 * static_cast<size_t>(B) * padded_stride(R));
}

// CTA 0, the drawer, walks the tile rows in order.  For row i, warp 0 runs
// the B guarded draws (draws.cuh) against the diagonal tile, scaled by n
// where it is read, from r_hat of block i in shared memory and writes dg.
// Meanwhile one thread has the copy engine bring row i + 1's diagonal tile
// and the tile (i, i + 1) into shared memory (cp.async.bulk: no load
// instructions compete with the chain for the SM's memory pipe), warps 1-7
// publish row i - 1's dg and the drawer's contribution to block i, stage
// row i + 1's packed rows, and warp 1, once every contribution to block
// i + 1 but the drawer's own has landed, reads r_hat of block i + 1.  Then
// the whole CTA adds n T(i, i + 1)^T dg_i to it in shared memory (and to
// r_hat), and row i + 1 draws at once: per row, the chain, the product of
// one tile in shared memory and three barriers.  Stamps (clock64) per row:
// before the draws, after them, after the first barrier, after the last.
template <int MI, int NF, bool GUARD>
__device__ __forceinline__ void drawer(const TiledArgs& a, float* sm) {
  constexpr int R = row_stride(MI, NF, GUARD);
  constexpr int RP = padded_stride(R);
  const int B = a.B;
  const unsigned tile_bytes = static_cast<unsigned>(sizeof(float)) * B * B;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);   // W buffers 0 and 1, then Tn
  float* red = sm + kBarFloats;
  float* dgs = red + kTiledWarps * kMaxBlock;
  float* rcur = dgs + kMaxBlock;   // r_hat of the row to draw
  float* rpre = rcur + kMaxBlock;  // r_hat of the next row, before the drawer's contribution
  // the two buffers of the diagonal tile and of the packed rows are
  // addressed by offsets from the shared array, never through a table of
  // pointers, so their loads stay shared-memory loads
  float* Wd0 = rpre + kMaxBlock;   // + buf B * B
  float* Tn = Wd0 + 2 * B * B;
  float* Pd0 = Tn + (a.stage_next ? B * B : 0);   // + buf B * RP
  auto Wd = [&](int buf) { return Wd0 + buf * B * B; };
  auto Pd = [&](int buf) { return Pd0 + buf * B * RP; };
  const float* tiles = a.tiles;
  auto tile = [&](int i, int k) { return tiles + (static_cast<long long>(i) * a.K + k) * B * B; };
  long long* st = a.stamps;
  const unsigned done = a.epoch + 1;
  auto base = [&](int t) { return a.epoch * static_cast<unsigned>(a.total[t]); };
  if (st != nullptr && threadIdx.x == 0) {
    st[4 * a.nbr] = global_ns();
    st[4 * a.nbr + 2] = clock64();
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) mbar_init(bar + q);
    mbar_expect(bar, tile_bytes);
    bulk_copy(Wd(0), tile(0, 0), tile_bytes, bar);
    await(a.cnt, base(0) + a.need[0]);
  }
  stage_rows<R>(a, 0, Pd(0), threadIdx.x, kTiledThreads);
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < B) rcur[threadIdx.x] = __ldcg(a.r_hat + threadIdx.x);
  __syncthreads();
  unsigned tn_uses = 0;
  for (int i = 0; i < a.nbr; ++i) {
    const int cur = i & 1;
    const int nx = a.nxt[i];
    const bool last = i + 1 == a.nbr;
    if (warp == 0) {
      if (st != nullptr && lane == 0) st[4 * i] = clock64();
      mbar_wait(bar + cur, (i >> 1) & 1);   // row i's diagonal tile has landed
      const long long kb = static_cast<long long>(i) * B;
      float rr[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = kSlots * lane + s;
        rr[s] = j < B ? rcur[j] : 0.f;
        gi[s] = dg[s] = tr[s] = 0.f;
      }
      const int rej = warp_block_draws<MI, NF, GUARD, true>(B, Wd(cur), Pd(cur), rr, gi, dg,
                                                            tr, a.vary, a.n);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = kSlots * lane + s;
        if (j < B) {
          a.dg[kb + j] = dg[s];
          a.tr[kb + j] = tr[s];
          dgs[j] = dg[s];
        }
      }
      if (lane == 0) {
        a.nrej[i] = rej;
        if (st != nullptr) st[4 * i + 1] = clock64();
      }
    } else {
      if (threadIdx.x == kWarp) {
        // the buffers the copies overwrite were last read by generic loads
        fence_async();
        if (!last) {
          mbar_expect(bar + (cur ^ 1), tile_bytes);
          bulk_copy(Wd(cur ^ 1), tile(i + 1, 0), tile_bytes, bar + (cur ^ 1));
        }
        if (nx >= 0 && a.stage_next) {
          mbar_expect(bar + 2, tile_bytes);
          bulk_copy(Tn, tile(i, nx), tile_bytes, bar + 2);
        }
        if (i > 0) {
          publish(a.flags + i - 1, done);
          if (a.nxt[i - 1] >= 0) publish(a.cnt + i, base(i) + a.need[i]);
        }
      }
      if (!last) {
        stage_rows<R>(a, i + 1, Pd(cur ^ 1), threadIdx.x - kWarp, kTiledThreads - kWarp);
        if (warp == 1) {
          if (lane == 0)
            await(a.cnt + i + 1, base(i + 1) + a.need[i + 1] - (nx >= 0 ? 1 : 0));
          __syncwarp();
          for (int c = lane; c < B; c += kWarp)
            rpre[c] = __ldcg(a.r_hat + static_cast<long long>(i + 1) * B + c);
        }
        cp_async_wait<0>();
      }
    }
    __syncthreads();   // dg in dgs; row i + 1's rows and r_hat staged
    if (st != nullptr && threadIdx.x == 0) st[4 * i + 2] = clock64();
    if (nx >= 0) {
      if (a.stage_next) mbar_wait(bar + 2, tn_uses++ & 1);
      float4 x[kTileRows];
      tile_rows(a.stage_next ? Tn : tile(i, nx), B, x);
      tile_partial(x, dgs, red, B);
      __syncthreads();
      if (threadIdx.x < B) {
        const float v = rpre[threadIdx.x] + a.n * tile_sum(red, threadIdx.x);
        rcur[threadIdx.x] = v;
        __stcg(a.r_hat + static_cast<long long>(i + 1) * B + threadIdx.x, v);
      }
    } else if (!last && threadIdx.x < B) {
      rcur[threadIdx.x] = rpre[threadIdx.x];
    }
    __syncthreads();   // rcur holds r_hat of row i + 1
    if (st != nullptr && threadIdx.x == 0) st[4 * i + 3] = clock64();
  }
  if (threadIdx.x == kWarp) publish(a.flags + a.nbr - 1, done);
  if (st != nullptr && threadIdx.x == 0) {
    st[4 * a.nbr + 1] = global_ns();
    st[4 * a.nbr + 3] = clock64();
  }
}

// CTAs 1 .. G-1 apply the other contributions: CTA c takes items c - 1,
// c - 1 + (G - 1), ... in order.  Each loads its tile into registers, waits
// for the row's dg, then applies it in its block's turn.
__device__ __forceinline__ void scatterer(const TiledArgs& a, float* sm) {
  float* red = sm;
  float* dgs = red + kTiledWarps * kMaxBlock;
  const int B = a.B;
  const unsigned done = a.epoch + 1;
  for (int w = blockIdx.x - 1; w < a.nitems; w += gridDim.x - 1) {
    const int4 it = a.items[w];   // row, slot, target block, sequence number
    float4 x[kTileRows];
    tile_rows(a.tiles + (static_cast<long long>(it.x) * a.K + it.y) * B * B, B, x);
    if (threadIdx.x == 0) await(a.flags + it.x, done);
    __syncthreads();   // dg of row it.x is published; the last item's red is read
    if (threadIdx.x < B) dgs[threadIdx.x] = __ldcg(a.dg + static_cast<long long>(it.x) * B + threadIdx.x);
    __syncthreads();
    apply_tile(a, x, dgs, red, it.z, static_cast<unsigned>(it.w));
  }
}

// grid G <= the CTAs that fit on the card at once (every CTA resident, so
// the flag waits cannot deadlock), kTiledThreads threads, dynamic shared
// memory tiled_smem.
template <int MI, int NF, bool GUARD>
__global__ void __launch_bounds__(kTiledThreads) tiled_sweep_kernel(TiledArgs a) {
  extern __shared__ __align__(16) float sm[];
  if (blockIdx.x == 0) drawer<MI, NF, GUARD>(a, sm);
  else scatterer(a, sm);
}

template <int MI, int NF, bool GUARD>
cudaError_t tiled_sweep(TiledArgs a, cudaStream_t stream) {
  constexpr int R = row_stride(MI, NF, GUARD);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  a.stage_next = tiled_smem(a.B, R, true) <= static_cast<size_t>(optin);
  const size_t smem = tiled_smem(a.B, R, a.stage_next);
  e = cudaFuncSetAttribute(tiled_sweep_kernel<MI, NF, GUARD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_sweep_kernel<MI, NF, GUARD>,
                                                      kTiledThreads, smem);
  if (e != cudaSuccess) return e;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long grid = 1 + (a.nitems < sms - 1 ? a.nitems : sms - 1);
  if (grid > resident) return cudaErrorCooperativeLaunchTooLarge;
  tiled_sweep_kernel<MI, NF, GUARD><<<static_cast<int>(grid), kTiledThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_tiled_sweep;
  return e;
}

// The draw chain alone: one warp runs `reps` blocks of B draws (draws.cuh)
// back to back on W (B, B) and P (B, R) held in shared memory, each block
// starting from r0 and depending on the one before it.  cycles gets the
// chain's clock64 cycles; out (B) the last block's dg (kept live).
template <int MI, int NF, bool GUARD>
__global__ void __launch_bounds__(kTiledThreads)
chain_kernel(const float* __restrict__ W, const float* __restrict__ P,
             const float* __restrict__ r0, int B, int reps, float vary,
             float* __restrict__ out, long long* cycles) {
  constexpr int R = row_stride(MI, NF, GUARD);
  constexpr int RP = padded_stride(R);
  extern __shared__ __align__(16) float sm[];
  float* Ws = sm;
  float* Ps = Ws + B * B;
  for (int e = threadIdx.x; e < B * B; e += blockDim.x) Ws[e] = W[e];
  for (int e = threadIdx.x; e < B * R; e += blockDim.x) {
    const int j = e / R;
    Ps[j * RP + e - j * R] = P[e];
  }
  __syncthreads();
  if (threadIdx.x >= kWarp) return;
  const int lane = threadIdx.x;
  float r0v[kSlots], rr[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = kSlots * lane + s;
    r0v[s] = j < B ? r0[j] : 0.f;
    dg[s] = gi[s] = tr[s] = 0.f;
  }
  int rej = 0;
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) rr[s] = r0v[s] + 0.f * dg[s];
    rej += warp_block_draws<MI, NF, GUARD>(B, Ws, Ps, rr, gi, dg, tr, vary);
  }
  const long long t1 = clock64();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = kSlots * lane + s;
    if (j < B) out[j] = dg[s] + static_cast<float>(rej);
  }
  if (lane == 0) *cycles = t1 - t0;
}

struct ChainArgs {
  const float* W;
  const float* P;
  const float* r0;
  int B, reps;
  float vary;
  float* out;
  long long* cycles;
};

template <int MI, int NF, bool GUARD>
cudaError_t chain_run(const ChainArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(a.B) *
                      (a.B + padded_stride(row_stride(MI, NF, GUARD)));
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<MI, NF, GUARD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  chain_kernel<MI, NF, GUARD><<<1, kTiledThreads, smem, stream>>>(
      a.W, a.P, a.r0, a.B, a.reps, a.vary, a.out, a.cycles);
  return cudaGetLastError();
}

// Model dispatch: models 1-5 have two folds; BayesR 2..kMaxFold; the guard
// exists for BayesC (4) and BayesR (6) only.
template <template <int, int, bool> class F, typename A>
cudaError_t dispatch(const A& a, int mi, int nf, bool guard, cudaStream_t s) {
  if (guard) {
    switch (mi == 6 ? nf : (mi == 4 ? 0 : -1)) {
      case 0: return F<4, 2, true>::run(a, s);
      case 2: return F<6, 2, true>::run(a, s);
      case 3: return F<6, 3, true>::run(a, s);
      case 4: return F<6, 4, true>::run(a, s);
      case 5: return F<6, 5, true>::run(a, s);
      case 6: return F<6, 6, true>::run(a, s);
      case 7: return F<6, 7, true>::run(a, s);
      case 8: return F<6, 8, true>::run(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (mi) {
    case 1: return F<1, 2, false>::run(a, s);
    case 2: return F<2, 2, false>::run(a, s);
    case 3: return F<3, 2, false>::run(a, s);
    case 4: return F<4, 2, false>::run(a, s);
    case 5: return F<5, 2, false>::run(a, s);
    default: break;
  }
  switch (nf) {
    case 2: return F<6, 2, false>::run(a, s);
    case 3: return F<6, 3, false>::run(a, s);
    case 4: return F<6, 4, false>::run(a, s);
    case 5: return F<6, 5, false>::run(a, s);
    case 6: return F<6, 6, false>::run(a, s);
    case 7: return F<6, 7, false>::run(a, s);
    case 8: return F<6, 8, false>::run(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int MI, int NF, bool GUARD>
struct SegSweep {
  static cudaError_t run(const SegArgs& a, cudaStream_t s) {
    return seg_sweep<MI, NF, GUARD>(a, s);
  }
};

template <int MI, int NF, bool GUARD>
struct TiledSweep {
  static cudaError_t run(const TiledArgs& a, cudaStream_t s) {
    return tiled_sweep<MI, NF, GUARD>(a, s);
  }
};

template <int MI, int NF, bool GUARD>
struct ChainRun {
  static cudaError_t run(const ChainArgs& a, cudaStream_t s) {
    return chain_run<MI, NF, GUARD>(a, s);
  }
};

}  // namespace hb

extern "C" {

const char* hb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches since the last reset: segment draws, segment updates, tiled
// sweeps.
void hb_s_launch_counts(long long* out) {
  out[0] = hb::g_seg_draws;
  out[1] = hb::g_seg_update;
  out[2] = hb::g_tiled_sweep;
}

void hb_s_reset_launch_counts() {
  hb::g_seg_draws = hb::g_seg_update = hb::g_tiled_sweep = 0;
}

// Sweep one dense LD segment for K chains.  LD (mc, mc) row-major; P
// (K, R, mc) packed rows; r (K, mc) updated in place; dg, track (K, mc)
// outputs.  mc % B == 0; LD, P, r and dg 16-byte aligned.
int hb_sweep_s_segment(const float* LD, const float* P, int mc, int B, int R,
                       int K, int mi, int nf, float n, float* r, float* dg,
                       float* track, void* stream) {
  if (!hb::block_ok(B, mi, nf) || mc <= 0 || mc % B != 0 || K <= 0 ||
      R != hb::packed_rows(mi, nf))
    return cudaErrorInvalidValue;
  const hb::SegArgs a{LD, P, mc, B, K, n, r, dg, track};
  return hb::dispatch<hb::SegSweep>(a, mi, nf, false, static_cast<cudaStream_t>(stream));
}

// Sweep every tile row of a tiled LD in one launch.  tiles (nbr, K, B, B),
// the diagonal tile in slot 0; P (R, nbr * B) packed rows (with the guard
// rows when guard); r_hat (nbr * B,) updated in place; dg, track (nbr * B,)
// and nrej (nbr,) outputs.  The schedule (need, nxt, total (nbr,); items
// (nitems, 4): row, slot, target block, sequence number) and the counters
// cnt, flags (nbr,) with this sweep's epoch are hb::TiledArgs'.  stamps
// (measurement only; null in use): 4 nbr + 4 values, see hb::drawer.
int hb_sweep_s_tiled(const float* tiles, int nbr, int K, int B, int R, int mi,
                     int nf, int guard, float n, float vary, const float* P,
                     float* r_hat, float* dg, float* track, int* nrej,
                     const int* need, const int* nxt, const int* items, int nitems,
                     const int* total, unsigned* cnt, unsigned* flags, unsigned epoch,
                     long long* stamps, void* stream) {
  const bool g = guard != 0;
  if (!hb::block_ok(B, mi, nf) || nbr <= 0 || K <= 0 || nitems < 0 ||
      (g && mi != 4 && mi != 6) || R != hb::row_stride(mi, nf, g))
    return cudaErrorInvalidValue;
  const hb::TiledArgs a{tiles, nbr, K, B, n, vary, P, r_hat, dg, track, nrej, need, nxt,
                        reinterpret_cast<const int4*>(items), nitems, total, cnt, flags,
                        epoch, 0, stamps};
  return hb::dispatch<hb::TiledSweep>(a, mi, nf, g, static_cast<cudaStream_t>(stream));
}

// The draw chain alone (measurement): reps blocks of B draws back to back
// in one warp on W (B, B) and P (B, R), R = row_stride(mi, nf, guard).
int hb_chain_latency(const float* W, const float* P, const float* r0, int B, int R,
                     int mi, int nf, int guard, float vary, int reps, float* out,
                     long long* cycles, void* stream) {
  const bool g = guard != 0;
  if (!hb::block_ok(B, mi, nf) || reps <= 0 || (g && mi != 4 && mi != 6) ||
      R != hb::row_stride(mi, nf, g))
    return cudaErrorInvalidValue;
  const hb::ChainArgs a{W, P, r0, B, reps, vary, out, cycles};
  return hb::dispatch<hb::ChainRun>(a, mi, nf, g, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

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
// and, with the SBayesS guard, the XLA scan the JAX package runs for
// reject_guard specs on chi-square-pruned and per-chromosome LD
// (hibayes_tpu/engine/sgibbs.py:309-372, engine/gibbs.py:311-331): the
// segment sweep draws with the tiled kernel's guard rule (8 pre-drawn
// candidates, the first that passes, else 0) instead of the scan's up to
// 100 redraws; the two differ only where all 8 candidates fail.
//
// The chain state is r_hat, the adjusted X'y.  Per block b of B SNPs the
// TPU kernels draw B effects against the Gram rows n * LD[block, block],
// then add n * LD[:, block] dg to r_hat (SBayesD.cpp:264-267), carrying
// r_hat in VMEM across an in-order grid.  CTAs run in no order here.
//
// The dense segment sweep is one persistent launch (seg_sweep_kernel), a
// grid no larger than the CTAs that fit on the card at once:
//   drawer CTAs, one per 8 chains (fewer where B = 128 leaves no room):
//     warp w draws chain w's block b (draws.cuh) against the Gram block
//     n LD[b, b] staged in shared memory, dg_b is published (a release
//     flag), and the CTA itself adds n LD[b + 1, b] dg_b to r of block
//     b + 1 (staged under block b's chain), so that block b + 1 waits only
//     for the owners of its rows to have finished block b - 1;
//   row-owner CTAs: each warp owns a fixed range of rows for the whole
//     sweep, a lane a row at a time, the CTA keeps r of its rows in shared
//     memory, streams LD[its rows, block b] through double-buffered
//     cp.async tiles under the wait for dg_b, and applies every block to
//     every row it owns in block order; the LD column block is read once
//     for all chains.
// Both form a row's sum alike (row_sum: one thread forms the products and
// the shuffle tree of the two-launch update kernel this replaced, in that
// tree's order), so the drawer's redundant
// copy for block b + 1's rows is bit for bit the owners', and every output
// is that kernel's.  The flags run on across sweeps (an epoch), so
// nothing is reset between sweeps.
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
// sweeps (an epoch), so nothing is reset between sweeps.  A batch of K
// chains is one launch too: CTAs 0 .. K - 1 are one drawer each (chain k's
// r_hat, packed rows, dg and counts), and every other CTA applies each of
// its contributions to all K chains from one read of its tile, chain by
// chain, each once that chain's row is published and in that chain's
// turn on the block.  The counters and flags are per chain (K x nbr), so
// chain k of a K-chain launch is bit for bit a one-chain launch on chain
// k's inputs, and the tiles are read once a sweep, not K times.
//
// What bounds them on this card: not device memory (the tiled sweep of the
// m = 500,000 band moves 2.34 GB, 0.70 ms at 3.35 TB/s; a dense segment of
// m = 32,768 4.3 GB, 1.28 ms) but the dependent draw chain of each block:
// B draws in one warp, 128 a block, which no amount of parallel hardware
// shortens (its latency alone: hb_chain_latency, PERF.md).  Both sweeps
// take the launches and the hand-offs off the chain: the segment sweep
// leaves per block the longer of the chain with the drawer's own
// contribution and the owners' pass over LD[:, block b] (8 MB at m =
// 32,768, B = 64); the tiled sweep per row the chain, the product of one
// tile in shared memory and three barriers.
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

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / kWarp;
constexpr int kSegChains = kSegWarps;  // chains a drawer CTA can draw (a warp each)
constexpr int kTiles = 3;              // row tiles in flight a row-owner warp
constexpr int kSegStamps = 12;         // stamps a block

// Launches of each kernel, counted where it is launched (hb_s_launch_counts).
long long g_segment_sweep = 0, g_tiled_sweep = 0;

// Inputs of the persistent segment sweep (csrc comment at seg_sweep_kernel;
// the plan is ops/blockgibbs.py:segment_plan).
struct SegArgs {
  const float* LD;     // (mc, mc) row-major
  const float* P;      // (K, R, mc) packed rows (and the guard rows with GUARD)
  int mc, B, K;
  float n, vary;       // vary: the guard's bound (read only with GUARD)
  int* nrej;           // (K, mc / B) per chain and block: the guard's counts (with GUARD)
  float *r, *dg, *tr;  // (K, mc): r in place; dg, tr out
  float* snap;         // (2, K, B) scratch: r of a block two ahead, from its owners
  unsigned* flags;     // K chain flags, then nown owner flags; run on by the epoch
  unsigned epoch;
  int ndraw, cpc;      // drawer CTAs, chains a drawer CTA
  int nown, rw;        // row-owner CTAs, rows a row-owner warp
  int kch;             // chains a row-owner pass
  int trows;           // rows of a row-owner tile: one a lane (32, or 16 at B = 128)
  int lds;             // row stride of the drawer's tile LD[b + 1, b] (B, or B + 4)
  long long* stamps;   // measurement only (null in use)
  int nf;              // BayesR folds (read by the NF = kRuntimeFold instance)
  // the packed rows in global memory, SNP-major at padded_stride(R) (K, mc,
  // RP), read there by the draws (through L2) instead of staged in shared
  // memory: where one SNP's rows overflow it; null: staged from P
  const float* Pg;
};

// One row's sum sum_c x[c] d[c] over a row slice of B <= 128 columns, by
// one thread, as the two-launch update kernel this replaced formed it
// across a warp: the partial of "lane" l over columns 4l .. 4l + 3 (the
// same products and sums; zero past B), then that kernel's shuffle tree
// over the 32 partials, level by level (p_i + p_{i+16}, then + the sum
// 8 on, 4, 2, 1), so the value is bit for bit that tree's in its lane 0.
// x: the row's slice as float4s (zero past B), d in shared memory,
// 16-byte aligned.
__device__ __forceinline__ float row_sum(const float4 (&x)[kWarp], const float* d, int B) {
  float a[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    float lo = 0.f, hi = 0.f;
    if (4 * l < B) {
      const float4 dv = *reinterpret_cast<const float4*>(d + 4 * l);
      lo = x[l].x * dv.x + x[l].y * dv.y + x[l].z * dv.z + x[l].w * dv.w;
    }
    if (4 * (l + 16) < B) {
      const float4 dv = *reinterpret_cast<const float4*>(d + 4 * (l + 16));
      hi = x[l + 16].x * dv.x + x[l + 16].y * dv.y + x[l + 16].z * dv.z + x[l + 16].w * dv.w;
    }
    a[l] = lo + hi;
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] += a[l + 8];
#pragma unroll
  for (int l = 0; l < 4; ++l) a[l] += a[l + 4];
  a[0] += a[2];
  a[1] += a[3];
  return a[0] + a[1];
}

// A row slice of B floats in shared memory (16-byte aligned) as float4s.
__device__ __forceinline__ void load_row(const float* p, int B, float4 (&x)[kWarp]) {
#pragma unroll
  for (int l = 0; l < kWarp; ++l)
    x[l] = 4 * l < B ? *reinterpret_cast<const float4*>(p + 4 * l)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Shared memory of a drawer CTA in floats: two Gram blocks, the tile
// LD[b + 1, b] at row stride lds, two blocks of packed rows for cpc
// chains (RP 0 where the draws read them from global memory), and (cpc B
// each) dg of the block drawn, r of the block to draw, the drawer's
// contribution's sums and r of block 1 as it starts.
__host__ __device__ inline long long seg_draw_floats(int B, int RP, int cpc, int lds) {
  return 2LL * B * B + static_cast<long long>(B) * lds + 2LL * cpc * B * RP + 4LL * cpc * B;
}

// Shared memory of a row-owner CTA in floats: each warp's kTiles row tiles
// (trows x (B + 4)), dg of one block for kch chains, and r of the CTA's
// rows for kch chains.
__host__ __device__ inline long long seg_own_floats(int B, int rw, int kch, int trows) {
  return static_cast<long long>(kSegWarps) * kTiles * trows * (B + 4) +
         static_cast<long long>(kch) * B + static_cast<long long>(kSegWarps) * rw * kch;
}

// A drawer CTA: chains k0 .. k0 + kc - 1, warp w chain k0 + w.  For block
// b it draws (draws.cuh, against n LD[b, b] staged and scaled), writes dg
// and track, and each warp publishes its chain's dg_b (flag epoch + b +
// 1).  Then, while the row owners apply dg_b to every row, it forms r of
// block b + 1 itself:
// r after block b - 1 (its owners' snapshot, or r as the sweep began for
// block 1) plus n LD[b + 1, b] dg_b (row_sum, a thread a row and chain),
// so that block b + 1 draws as soon as its owners have finished block
// b - 1.  Block b + 1's Gram block, the tile LD[b + 1, b] and its packed
// rows land (cp.async, issued by the warps that draw no chain, from L2,
// where they were prefetched two blocks ahead) under block b's chain.
// With GUARD the draws apply the SBayesS guard (draws.cuh) and each warp
// writes its chain's counts for the block to nrej.
template <int MI, int NF, bool GUARD>
__device__ __forceinline__ void seg_drawer(const SegArgs& a, float* sm) {
  const int R = row_stride(MI, NF == kRuntimeFold ? a.nf : NF, GUARD);
  const int RP = padded_stride(R);
  const bool rows_smem = !rows_may_be_global<NF>() || a.Pg == nullptr;
  const int RS = rows_smem ? RP : 0;   // floats a SNP's rows take in shared memory
  const int B = a.B, cpc = a.cpc, lds = a.lds;
  const long long mc = a.mc;
  const int nb = a.mc / B;
  const int k0 = blockIdx.x * cpc;
  const int kc = min(cpc, a.K - k0);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int B4 = B / 4;
  float* G0 = sm;                       // + (b & 1) B B
  float* Ls = G0 + 2 * B * B;           // B rows at stride lds
  float* P0 = Ls + B * lds;             // + (b & 1) cpc B RP
  float* dgs = P0 + 2 * cpc * B * RS;   // (kc, B)
  float* rr = dgs + cpc * B;            // (kc, B): r of the block to draw
  float* ps = rr + cpc * B;             // (kc, B): the contribution's sums
  float* r1 = ps + cpc * B;             // (kc, B): r of block 1 as the sweep began
  long long* st = blockIdx.x == 0 ? a.stamps : nullptr;
  // the threads that stage: the warps that draw no chain, or all when each
  // draws one (then before their chains)
  const int s0 = kc < kSegWarps ? kc * kWarp : 0;
  const int sn = kSegThreads - s0;
  const bool stager = tid >= s0;
  auto stage = [&](int b) {   // block b's Gram block, LD[b, b - 1] and packed rows
    const long long row0 = static_cast<long long>(b) * B;
    float* G = G0 + (b & 1) * B * B;
    for (int e = tid - s0; e < B * B4; e += sn) {
      const int i = e / B4, c = 4 * (e - i * B4);
      cp_async16(G + i * B + c, a.LD + (row0 + i) * mc + row0 + c);
      if (b > 0) cp_async16(Ls + i * lds + c, a.LD + (row0 + i) * mc + row0 - B + c);
    }
    float* Pd = P0 + (b & 1) * cpc * B * RP;
    for (int e = tid - s0; rows_smem && e < kc * B * R; e += sn) {
      const int kk = e / (B * R), rest = e - kk * B * R;
      const int row = rest / B, j = rest - row * B;
      cp_async4(Pd + kk * B * RP + j * RP + row,
                a.P + (static_cast<long long>(k0 + kk) * R + row) * mc + row0 + j);
    }
    cp_async_commit();
  };
  auto scale = [&](int b) {   // the Gram block times n, in place (as the parent staged it)
    float4* G = reinterpret_cast<float4*>(G0 + (b & 1) * B * B);
    for (int e = tid; e < B * B4; e += kSegThreads) {
      float4 w = G[e];
      w.x *= a.n; w.y *= a.n; w.z *= a.n; w.w *= a.n;
      G[e] = w;
    }
  };
  if (st != nullptr && tid == 0) {
    st[kSegStamps * nb] = global_ns();
    st[kSegStamps * nb + 2] = clock64();
  }
  if (stager) stage(0);
  for (int e = tid; e < kc * B; e += kSegThreads) {
    const int kk = e / B, j = e - kk * B;
    const long long base = static_cast<long long>(k0 + kk) * mc;
    rr[e] = __ldcg(a.r + base + j);
    if (nb > 1) r1[e] = __ldcg(a.r + base + B + j);
  }
  cp_async_wait<0>();
  __syncthreads();
  scale(0);
  __syncthreads();
  // L2 prefetch of what stage(b) copies, issued two blocks ahead: the
  // copies then hit L2 under the chain, however busy the row owners keep
  // device memory
  auto prefetch = [&](int b) {   // 128-byte lines: rows of block b, columns of b - 1 and b
    const long long row0 = static_cast<long long>(b) * B;
    const int lpr = (2 * B + 31) / 32;   // lines a row
    for (int e = tid - s0; e < B * lpr; e += sn)
      prefetch_line_l2(a.LD + (row0 + e / lpr) * mc + row0 - B + 32 * (e % lpr));
    const int lpp = (B + 31) / 32;
    for (int e = tid - s0; rows_smem && e < kc * R * lpp; e += sn)
      prefetch_line_l2(a.P + static_cast<long long>(k0 * R + e / lpp) * mc + row0 + 32 * (e % lpp));
  };
  if (nb > 2 && stager) prefetch(2);
  for (int b = 0; b < nb; ++b) {
    const long long col0 = static_cast<long long>(b) * B;
    if (stager) {
      if (b + 1 < nb) stage(b + 1);
      if (b + 3 < nb) prefetch(b + 3);
    }
    if (st != nullptr && tid == 0) st[kSegStamps * b] = clock64();
    if (warp < kc) {
      const long long kb = static_cast<long long>(k0 + warp) * mc + col0;
      float rv[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = kSlots * lane + s;
        rv[s] = j < B ? rr[warp * B + j] : 0.f;
        gi[s] = dg[s] = tr[s] = 0.f;
      }
      // two call sites: the shared-memory one keeps shared-memory loads
      const int rej =
          rows_smem
              ? warp_block_draws<MI, NF, GUARD>(B, G0 + (b & 1) * B * B,
                                                P0 + (b & 1) * cpc * B * RP + warp * B * RP, rv,
                                                gi, dg, tr, a.vary, 1.f, a.nf)
              : warp_block_draws<MI, NF, GUARD>(
                    B, G0 + (b & 1) * B * B,
                    a.Pg + (static_cast<long long>(k0 + warp) * mc + col0) * RP, rv, gi, dg, tr,
                    a.vary, 1.f, a.nf);
      if (GUARD && lane == 0) a.nrej[static_cast<long long>(k0 + warp) * nb + b] = rej;
      if (st != nullptr && tid == 0) st[kSegStamps * b + 10] = clock64();
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = kSlots * lane + s;
        if (j < B) {
          a.dg[kb + j] = dg[s];
          a.tr[kb + j] = tr[s];
          dgs[warp * B + j] = dg[s];
        }
      }
      __syncwarp();
      if (lane == 0) publish(a.flags + k0 + warp, a.epoch + b + 1);   // dg_b of this chain
      if (st != nullptr && tid == 0) st[kSegStamps * b + 11] = clock64();
    }
    cp_async_wait<0>();
    __syncthreads();   // dg of every chain in dgs and global memory; block b + 1 staged
    if (st != nullptr && tid == 0) st[kSegStamps * b + 1] = clock64();
    if (b + 1 == nb) break;
    scale(b + 1);
    // n LD[b + 1, b] dg_b: thread q the row q % B of chain q / B
    for (int q = tid; q < kc * B; q += kSegThreads) {
      const int kk = q / B, i = q - kk * B;
      float4 x[kWarp];
      load_row(Ls + i * lds, B, x);
      ps[q] = row_sum(x, dgs + kk * B, B);
    }
    if (st != nullptr && tid == 0) st[kSegStamps * b + 2] = clock64();
    if (b + 1 >= 2 && tid == 0) {   // the owners of block b + 1's rows have finished block b - 1
      const long long lo = static_cast<long long>(b + 1) * B, hi = lo + B - 1;
      const int rows_cta = kSegWarps * a.rw;
      for (int o = static_cast<int>(lo / rows_cta); o <= static_cast<int>(hi / rows_cta); ++o)
        await(a.flags + a.K + o, a.epoch + b);
    }
    __syncthreads();
    if (st != nullptr && tid == 0) st[kSegStamps * b + 3] = clock64();
    const float* snap = a.snap + (static_cast<long long>((b + 1) & 1) * a.K + k0) * B;
    for (int e = tid; e < kc * B; e += kSegThreads)
      rr[e] = (b + 1 >= 2 ? __ldcg(snap + e) : r1[e]) + a.n * ps[e];
    __syncthreads();   // rr holds r of block b + 1
    if (st != nullptr && tid == 0) st[kSegStamps * b + 4] = clock64();
  }
  if (st != nullptr && tid == 0) {
    st[kSegStamps * nb + 1] = global_ns();
    st[kSegStamps * nb + 3] = clock64();
  }
}

// A row-owner CTA: warp w owns rows (o 8 + w) rw .. + rw for the whole
// sweep, and the CTA keeps r of its rows in shared memory (kch chains at a
// time).  For each block b it waits for dg_b (every chain's flag); then
// each warp adds n LD[row, block b] dg_b to each of its rows and chains,
// in block order, a lane a row (row_sum), its LD rows streamed in tiles of
// trows rows (one block's columns, rows padded to B + 4 floats, so the
// lanes' reads spread over the banks) through kTiles buffers (cp.async,
// kTiles - 1 tiles ahead, across blocks); the rows of block b + 2 go to the
// snapshot too, for the drawer.  The CTA publishes "block b done" (flag
// epoch + b + 1) once all its warps are through.  With K > kch each pass
// over a block takes kch chains, and r of the CTA's rows goes back to
// global memory between passes.
__device__ __forceinline__ void seg_owner(const SegArgs& a, float* sm) {
  const int B = a.B, K = a.K, rw = a.rw, kch = a.kch, TR = a.trows;
  const int ldr = B + 4;
  const long long mc = a.mc;
  const int nb = a.mc / B;
  const int o = blockIdx.x - a.ndraw;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int B4 = B / 4;
  const int rows_cta = kSegWarps * rw;
  const long long crow0 = static_cast<long long>(o) * rows_cta;   // the CTA's first row
  const long long wrow0 = crow0 + static_cast<long long>(warp) * rw;
  float* ring = sm + warp * kTiles * TR * ldr;
  float* dgs = sm + kSegWarps * kTiles * TR * ldr;   // (kch, B)
  float* rs = dgs + kch * B;                          // (rows_cta, kch)
  const int nch = (K + kch - 1) / kch;
  const int tpw = (rw + TR - 1) / TR;                 // tiles a warp per pass
  const long long total = static_cast<long long>(nb) * nch * tpw;
  long long* st = (o == 0 && a.stamps != nullptr) ? a.stamps : nullptr;
  auto issue = [&](long long s) {   // tile s of the warp's stream into its buffer
    if (s < total) {
      const long long pass = s / tpw;
      const int g = static_cast<int>(s - pass * tpw);
      const long long b = pass / nch;
      float* U = ring + static_cast<int>(s % kTiles) * TR * ldr;
      for (int e = lane; e < TR * B4; e += kWarp) {
        const int v = e / B4, c = 4 * (e - v * B4);
        const int lr = g * TR + v;
        const long long row = wrow0 + lr;
        if (lr < rw && row < mc) cp_async16(U + v * ldr + c, a.LD + row * mc + b * B + c);
      }
    }
    cp_async_commit();
  };
  auto chunk_r = [&](int ch, bool load) {   // r of the CTA's rows, chains of pass ch
    const int kq0 = ch * kch, kq = min(kch, K - kq0);
    for (int e = tid; e < rows_cta * kq; e += kSegThreads) {
      const int kk = e / rows_cta, lr = e - kk * rows_cta;
      const long long row = crow0 + lr;
      if (row >= mc) continue;
      float* g = a.r + static_cast<long long>(kq0 + kk) * mc + row;
      if (load) rs[lr * kch + kk] = __ldcg(g);
      else __stcg(g, rs[lr * kch + kk]);
    }
  };
  for (int q = 0; q < kTiles - 1; ++q) issue(q);
  chunk_r(0, true);
  long long s = 0;
  for (int b = 0; b < nb; ++b) {
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();   // every warp is through the pass before (dgs and rs free)
      if (ch == 0 && tid == 0 && b > 0) {
        publish(a.flags + K + o, a.epoch + b);   // block b - 1 done
        if (st != nullptr) st[kSegStamps * (b - 1) + 6] = clock64();
      }
      // the pass's first copies, before the wait for dg_b: a full memory
      // pipe holds them back at issue, and the wait absorbs that
      __syncwarp();      // the buffer issue() refills was read by every lane
      issue(s + kTiles - 1);
      if (ch == 0) {
        if (tid == 0) {
          for (int c = 0; c < K; ++c) await(a.flags + c, a.epoch + b + 1);
          if (st != nullptr) st[kSegStamps * b + 5] = clock64();
        }
        __syncthreads();   // dg_b of every chain is published
      }
      if (nch > 1 && (b > 0 || ch > 0)) {
        chunk_r(ch == 0 ? nch - 1 : ch - 1, false);
        __syncthreads();
        chunk_r(ch, true);
      }
      const int kq0 = ch * kch, kq = min(kch, K - kq0);
      for (int e = tid; e < kq * B; e += kSegThreads) {
        const int kk = e / B, j = e - kk * B;
        dgs[e] = __ldcg(a.dg + static_cast<long long>(kq0 + kk) * mc +
                        static_cast<long long>(b) * B + j);
      }
      __syncthreads();   // dg_b of the pass's chains in dgs
      if (st != nullptr && tid == 0 && ch == 0) st[kSegStamps * b + 7] = clock64();
      const long long two = static_cast<long long>(b + 2) * B;
      for (int g = 0; g < tpw; ++g, ++s) {
        if (g > 0) {
          __syncwarp();
          issue(s + kTiles - 1);
        }
        cp_async_wait<kTiles - 1>();
        __syncwarp();    // tile s has landed, every lane's part of it
        if (st != nullptr && tid == 0 && ch == 0 && g == 0) st[kSegStamps * b + 8] = clock64();
        const int lr = warp * rw + g * TR + lane;   // the lane's row, within the CTA
        const long long row = crow0 + lr;
        if (lane >= TR || g * TR + lane >= rw || row >= mc) continue;
        float4 x[kWarp];   // the lane's row, read once for every chain
        load_row(ring + static_cast<int>(s % kTiles) * TR * ldr + lane * ldr, B, x);
        const bool snap = b + 2 < nb && row >= two && row < two + B;
        for (int kk = 0; kk < kq; ++kk) {
          float& rv = rs[lr * kch + kk];
          rv += a.n * row_sum(x, dgs + kk * B, B);
          if (snap)
            a.snap[(static_cast<long long>((b + 2) & 1) * K + kq0 + kk) * B + (row - two)] = rv;
        }
        if (st != nullptr && tid == 0 && ch == 0 && g == 0) st[kSegStamps * b + 9] = clock64();
      }
    }
  }
  __syncthreads();
  chunk_r(nch - 1, false);
  if (tid == 0) {
    publish(a.flags + K + o, a.epoch + nb);
    if (st != nullptr) st[kSegStamps * (nb - 1) + 6] = clock64();
  }
}

// The dense segment sweep, one persistent launch: CTAs 0 .. ndraw - 1 draw
// (seg_drawer), the others own rows (seg_owner).  Grid no larger than the
// CTAs that fit on the card at once (every CTA resident, so the flag waits
// cannot deadlock).
template <int MI, int NF, bool GUARD>
__global__ void __launch_bounds__(kSegThreads, 1) seg_sweep_kernel(SegArgs a) {
  extern __shared__ __align__(16) float sm[];
  if (static_cast<int>(blockIdx.x) < a.ndraw) seg_drawer<MI, NF, GUARD>(a, sm);
  else seg_owner(a, sm);
}

// Any fold count: BayesR above kMaxFold folds runs the NF = kRuntimeFold
// instance (the caller fits its rows in shared memory: ops/blockgibbs.py
// kernel_width).
inline bool block_ok(int B, int mi, int nf) {
  return B > 0 && B <= kMaxBlock && B % 4 == 0 && mi >= 1 && mi <= 6 &&
         nf >= 2 && (mi == 6 || nf <= kMaxFold);
}

template <int MI, int NF, bool GUARD>
cudaError_t seg_sweep(const SegArgs& a, cudaStream_t stream) {
  const int RP = padded_stride(row_stride(MI, NF == kRuntimeFold ? a.nf : NF, GUARD));
  const bool rows_smem = !rows_may_be_global<NF>() || a.Pg == nullptr;
  const long long fl = seg_draw_floats(a.B, rows_smem ? RP : 0, a.cpc, a.lds);
  const long long fo = seg_own_floats(a.B, a.rw, a.kch, a.trows);
  const size_t smem = sizeof(float) * static_cast<size_t>(fl > fo ? fl : fo);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(seg_sweep_kernel<MI, NF, GUARD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_sweep_kernel<MI, NF, GUARD>,
                                                      kSegThreads, smem);
  if (e != cudaSuccess) return e;
  const long long grid = static_cast<long long>(a.ndraw) + a.nown;
  if (grid > static_cast<long long>(per_sm) * sms) return cudaErrorCooperativeLaunchTooLarge;
  seg_sweep_kernel<MI, NF, GUARD><<<static_cast<int>(grid), kSegThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_segment_sweep;
  return e;
}

// ---------------------------------------------------------------------------
// the tiled sweep: one persistent launch
// ---------------------------------------------------------------------------
//
// A launch sweeps nbr tile rows, global rows rb .. rb + nbr - 1 of a store
// of nb rows (the SNP-sharded sweep gives each rank a shard of the rows;
// one device: rb 0, nb = nbr).  r_hat, the schedule's targets, total and
// cnt run over the nb global blocks; the rows' P, dg, tr, nrej, need, nxt
// and flags are the shard's own.

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
// and publishes flags[i] = epoch + 1.  With `chains` chains, P, r_hat,
// dg, tr, nrej, cnt and flags hold one chain after another
// (chain_args); the tiles and the schedule are shared.  Rows and items'
// rows are local (row i is global block rb + i); targets, r_hat, total
// and cnt are global (nb blocks).
struct TiledArgs {
  const float* tiles;
  int nbr, rb, nb, K, B, chains;
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
  int nf;             // BayesR folds (read by the NF = kRuntimeFold instance)
  // the packed rows in global memory, SNP-major at padded_stride(R) (chains,
  // nbr B, RP), read there by the draws (through L2) instead of staged in
  // shared memory: where one SNP's rows overflow it (BayesR with hundreds
  // of folds and the guard); null: staged from P
  const float* Pg;
};

// Chain c's arguments: its packed rows (R, nbr B), r_hat, dg, tr (nbr B),
// nrej, cnt and flags (nbr); chain 0 alone keeps the stamps.
__device__ __forceinline__ TiledArgs chain_args(TiledArgs a, int c, int R) {
  const long long m = static_cast<long long>(a.nbr) * a.B;
  a.P += c * R * m;
  if (a.Pg != nullptr) a.Pg += c * m * padded_stride(R);
  a.r_hat += c * static_cast<long long>(a.nb) * a.B;
  a.dg += c * m;
  a.tr += c * m;
  a.nrej += static_cast<long long>(c) * a.nbr;
  a.cnt += static_cast<long long>(c) * a.nb;
  a.flags += static_cast<long long>(c) * a.nbr;
  if (c != 0) a.stamps = nullptr;
  return a;
}

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
__device__ __forceinline__ void stage_rows(const TiledArgs& a, int R, int i, float* Pd,
                                           int t0, int nt) {
  const int RP = padded_stride(R);
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
// at padded_stride(R)) unless the draws read them from global memory.
inline size_t tiled_smem(int B, int R, bool stage_next, bool rows_smem = true) {
  return sizeof(float) * (kBarFloats + (kTiledWarps + 3) * kMaxBlock +
                          static_cast<size_t>(B) * B * (stage_next ? 3 : 2) +
                          (rows_smem ? 2 * static_cast<size_t>(B) * padded_stride(R) : 0));
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
  const int R = row_stride(MI, NF == kRuntimeFold ? a.nf : NF, GUARD);
  const int RP = padded_stride(R);
  const int B = a.B;
  const unsigned tile_bytes = static_cast<unsigned>(sizeof(float)) * B * B;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const bool rows_smem = !rows_may_be_global<NF>() || a.Pg == nullptr;
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
  const int rb = a.rb;   // row i is global block rb + i
  auto base = [&](int t) { return a.epoch * static_cast<unsigned>(a.total[t]); };
  if (st != nullptr && threadIdx.x == 0) {
    st[4 * a.nbr] = global_ns();
    st[4 * a.nbr + 2] = clock64();
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) mbar_init(bar + q);
    mbar_expect(bar, tile_bytes);
    bulk_copy(Wd(0), tile(0, 0), tile_bytes, bar);
    await(a.cnt + rb, base(rb) + a.need[0]);
  }
  if (rows_smem) stage_rows(a, R, 0, Pd(0), threadIdx.x, kTiledThreads);
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < B)
    rcur[threadIdx.x] = __ldcg(a.r_hat + static_cast<long long>(rb) * B + threadIdx.x);
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
      // two call sites, so that the shared-memory one keeps its rows' loads
      // shared-memory loads (a pointer that may be either is a generic load)
      const int rej =
          rows_smem ? warp_block_draws<MI, NF, GUARD, true>(B, Wd(cur), Pd(cur), rr, gi, dg, tr,
                                                            a.vary, a.n, a.nf)
                    : warp_block_draws<MI, NF, GUARD, true>(B, Wd(cur), a.Pg + kb * RP, rr, gi,
                                                            dg, tr, a.vary, a.n, a.nf);
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
          if (a.nxt[i - 1] >= 0) publish(a.cnt + rb + i, base(rb + i) + a.need[i]);
        }
      }
      if (!last) {
        if (rows_smem)
          stage_rows(a, R, i + 1, Pd(cur ^ 1), threadIdx.x - kWarp, kTiledThreads - kWarp);
        if (warp == 1) {
          if (lane == 0)
            await(a.cnt + rb + i + 1, base(rb + i + 1) + a.need[i + 1] - (nx >= 0 ? 1 : 0));
          __syncwarp();
          for (int c = lane; c < B; c += kWarp)
            rpre[c] = __ldcg(a.r_hat + static_cast<long long>(rb + i + 1) * B + c);
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
        __stcg(a.r_hat + static_cast<long long>(rb + i + 1) * B + threadIdx.x, v);
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

// CTAs C .. G-1 (C = a.chains) apply the other contributions: CTA c takes
// items c - C, c - C + (G - C), ... in order.  Each loads its tile into
// registers once, then for each chain in turn waits for that chain's row
// dg and applies it in its block's turn.  Each wait is for an earlier row
// (of a drawer, or of an item before this one in some CTA's order), so no
// wait can close a cycle.
__device__ __forceinline__ void scatterer(const TiledArgs& a, int R, float* sm) {
  float* red = sm;
  float* dgs = red + kTiledWarps * kMaxBlock;
  const int B = a.B;
  const unsigned done = a.epoch + 1;
  const int C = a.chains;
  for (int w = blockIdx.x - C; w < a.nitems; w += gridDim.x - C) {
    const int4 it = a.items[w];   // row, slot, target block, sequence number
    float4 x[kTileRows];
    tile_rows(a.tiles + (static_cast<long long>(it.x) * a.K + it.y) * B * B, B, x);
    for (int c = 0; c < C; ++c) {
      const TiledArgs ac = chain_args(a, c, R);
      if (threadIdx.x == 0) await(ac.flags + it.x, done);
      __syncthreads();   // dg of row it.x is published; the last item's red is read
      if (threadIdx.x < B)
        dgs[threadIdx.x] = __ldcg(ac.dg + static_cast<long long>(it.x) * B + threadIdx.x);
      __syncthreads();
      apply_tile(ac, x, dgs, red, it.z, static_cast<unsigned>(it.w));
    }
  }
}

// grid G <= the CTAs that fit on the card at once (every CTA resident, so
// the flag waits cannot deadlock), kTiledThreads threads, dynamic shared
// memory tiled_smem: CTAs 0 .. chains - 1 draw, one chain each.
template <int MI, int NF, bool GUARD>
__global__ void __launch_bounds__(kTiledThreads) tiled_sweep_kernel(TiledArgs a) {
  const int R = row_stride(MI, NF == kRuntimeFold ? a.nf : NF, GUARD);
  extern __shared__ __align__(16) float sm[];
  if (static_cast<int>(blockIdx.x) < a.chains)
    drawer<MI, NF, GUARD>(chain_args(a, blockIdx.x, R), sm);
  else scatterer(a, R, sm);
}

// The tiled sweep's launch at tiles of B with R rows a SNP: whether the
// drawer stages the tile (i, i + 1), its shared memory, the SM count and
// the CTAs the card holds at once.
struct TiledFit {
  int stage_next, sms;
  size_t smem;
  long long resident;
};

template <int MI, int NF, bool GUARD>
cudaError_t tiled_fit(int B, int R, TiledFit* f, bool rows_smem = true) {
  int dev = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&f->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  f->stage_next = tiled_smem(B, R, true, rows_smem) <= static_cast<size_t>(optin);
  f->smem = tiled_smem(B, R, f->stage_next, rows_smem);
  e = cudaFuncSetAttribute(tiled_sweep_kernel<MI, NF, GUARD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(f->smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_sweep_kernel<MI, NF, GUARD>,
                                                      kTiledThreads, f->smem);
  f->resident = static_cast<long long>(per_sm) * f->sms;
  return e;
}

template <int MI, int NF, bool GUARD>
cudaError_t tiled_sweep(TiledArgs a, cudaStream_t stream) {
  const int R = row_stride(MI, NF == kRuntimeFold ? a.nf : NF, GUARD);
  TiledFit f;
  cudaError_t e = tiled_fit<MI, NF, GUARD>(a.B, R, &f,
                                           !rows_may_be_global<NF>() || a.Pg == nullptr);
  if (e != cudaSuccess) return e;
  a.stage_next = f.stage_next;
  const size_t smem = f.smem;
  const long long sms = f.sms;
  const long long resident = f.resident;
  const long long spare = sms - a.chains;   // item CTAs: one an SM left, at least one
  const long long grid =
      a.chains + (a.nitems == 0 ? 0 : (a.nitems < spare ? a.nitems : (spare > 1 ? spare : 1)));
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
             float* __restrict__ out, long long* cycles, int nf) {
  const int R = row_stride(MI, NF == kRuntimeFold ? nf : NF, GUARD);
  const int RP = padded_stride(R);
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
    rej += warp_block_draws<MI, NF, GUARD>(B, Ws, Ps, rr, gi, dg, tr, vary, 1.f, nf);
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
  int nf;
};

template <int MI, int NF, bool GUARD>
cudaError_t chain_run(const ChainArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(a.B) *
                      (a.B + padded_stride(row_stride(MI, NF == kRuntimeFold ? a.nf : NF,
                                                      GUARD)));
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<MI, NF, GUARD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  chain_kernel<MI, NF, GUARD><<<1, kTiledThreads, smem, stream>>>(
      a.W, a.P, a.r0, a.B, a.reps, a.vary, a.out, a.cycles, a.nf);
  return cudaGetLastError();
}

// Model dispatch: models 1-5 have two folds; BayesR 2..kMaxFold compiled
// in, more folds the NF = kRuntimeFold instance; the guard exists for
// BayesC (4) and BayesR (6) only.
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
      case -1: return cudaErrorInvalidValue;
      default: return F<6, kRuntimeFold, true>::run(a, s);
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
    default: return F<6, kRuntimeFold, false>::run(a, s);
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

// The CTAs of the tiled sweep the card holds at once (hb_tiled_resident).
struct ResidentArgs {
  int B, nf, rows_smem;
  long long* out;
};

template <int MI, int NF, bool GUARD>
struct TiledResident {
  static cudaError_t run(const ResidentArgs& a, cudaStream_t) {
    TiledFit f;
    const cudaError_t e =
        tiled_fit<MI, NF, GUARD>(a.B, row_stride(MI, NF == kRuntimeFold ? a.nf : NF, GUARD), &f,
                                 !rows_may_be_global<NF>() || a.rows_smem != 0);
    if (e == cudaSuccess) *a.out = f.resident;
    return e;
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

// Launches since the last reset: segment sweeps, tiled sweeps.
void hb_s_launch_counts(long long* out) {
  out[0] = hb::g_segment_sweep;
  out[1] = hb::g_tiled_sweep;
}

void hb_s_reset_launch_counts() { hb::g_segment_sweep = hb::g_tiled_sweep = 0; }

// Sweep one dense LD segment for K chains in one launch.  LD (mc, mc)
// row-major; P (K, R, mc) packed rows (with the guard rows when guard); r
// (K, mc) updated in place; dg, track (K, mc) outputs; snap (2, K, B)
// scratch; with guard (BayesC/Cpi, BayesR) the SBayesS guard at vary, its
// counts per chain and block into nrej (K, mc / B; draws.cuh
// warp_block_draws).  The plan
// (ops/blockgibbs.py:segment_plan): ndraw drawer CTAs of cpc chains, nown
// row-owner CTAs of 8 warps, each warp rw rows in tiles of trows, kch
// chains a row-owner pass, the drawer's tile at row stride lds.  flags
// (K chains', then nown row owners') run on across sweeps: this sweep
// publishes epoch + 1 .. epoch + mc / B.  mc % B == 0; LD, P, r
// and dg 16-byte aligned.  A grid that cannot be resident at once is
// refused (cudaErrorCooperativeLaunchTooLarge).  stamps (measurement only;
// null in use): 12 values a block (hb::seg_drawer, hb::seg_owner), then
// %globaltimer ns and clock64 at the drawer's start and end.  Pg (null, or
// the packed rows (K, mc, padded_stride(R)) SNP-major): the draws read the
// rows there instead of staging P in shared memory (the plan sized for no
// rows in shared memory).
int hb_sweep_s_segment(const float* LD, const float* P, int mc, int B, int R,
                       int K, int mi, int nf, int guard, float n, float vary, int* nrej,
                       float* r, float* dg,
                       float* track, float* snap, unsigned* flags, unsigned epoch,
                       int ndraw, int cpc, int nown, int rw, int kch, int trows, int lds,
                       long long* stamps, const float* Pg, void* stream) {
  const bool g = guard != 0;
  if (!hb::block_ok(B, mi, nf) || mc <= 0 || mc % B != 0 || K <= 0 ||
      (g && ((mi != 4 && mi != 6) || nrej == nullptr)) ||
      R != hb::row_stride(mi, nf, g) || cpc < 1 || cpc > hb::kSegChains ||
      ndraw != (K + cpc - 1) / cpc || rw < 1 || nown < 1 ||
      static_cast<long long>(nown) * hb::kSegWarps * rw < mc || kch < 1 || trows < 1 ||
      trows > hb::kWarp || (lds != B && lds != B + 4) ||
      (Pg != nullptr && !hb::global_rows_ok(mi, nf)))
    return cudaErrorInvalidValue;
  const hb::SegArgs a{LD, P, mc, B, K, n, vary, nrej, r, dg, track, snap, flags, epoch,
                      ndraw, cpc, nown, rw, kch, trows, lds, stamps, nf, Pg};
  return hb::dispatch<hb::SegSweep>(a, mi, nf, g, static_cast<cudaStream_t>(stream));
}

// Sweep tile rows row_base .. row_base + nbr - 1 of a tiled LD of nb tile
// rows (all of them: row_base 0, nb = nbr) for `chains` chains in one
// launch.  tiles (nbr, K, B, B) the rows' tiles, the diagonal tile in slot
// 0; per chain: P (chains, R, nbr * B) packed rows (with the guard rows
// when guard); r_hat (chains, nb * B) updated in place; dg, track (chains,
// nbr * B) and nrej (chains, nbr) outputs (nrej: the guard's counts of
// each row, draws.cuh warp_block_draws).  Any B <= kMaxBlock that is a
// multiple of 4 (tiles of 64 or 128): the tile-row loops skip rows past
// B.  The schedule (need, nxt (nbr,); total (nb,); items (nitems, 4): row,
// slot, target block, sequence number), shared by the chains, and the
// counters cnt (chains, nb), flags (chains, nbr) with this sweep's epoch
// are hb::TiledArgs'.  A grid of the chains'
// drawers and at least one item CTA that cannot be resident at once is
// refused (cudaErrorCooperativeLaunchTooLarge).  stamps (measurement only;
// null in use; chain 0's): 4 nbr + 4 values, see hb::drawer.  Pg (null, or
// the packed rows (chains, nbr * B, padded_stride(R)) SNP-major): the draws
// read the rows there instead of staging P in shared memory.
int hb_sweep_s_tiled(const float* tiles, int nbr, int row_base, int nb, int K, int B, int R,
                     int chains, int mi,
                     int nf, int guard, float n, float vary, const float* P,
                     float* r_hat, float* dg, float* track, int* nrej,
                     const int* need, const int* nxt, const int* items, int nitems,
                     const int* total, unsigned* cnt, unsigned* flags, unsigned epoch,
                     long long* stamps, const float* Pg, void* stream) {
  const bool g = guard != 0;
  if (!hb::block_ok(B, mi, nf) || nbr <= 0 || row_base < 0 || nb < row_base + nbr ||
      K <= 0 || nitems < 0 || chains < 1 || (g && mi != 4 && mi != 6) ||
      R != hb::row_stride(mi, nf, g) || (Pg != nullptr && !hb::global_rows_ok(mi, nf)))
    return cudaErrorInvalidValue;
  const hb::TiledArgs a{tiles, nbr, row_base, nb, K, B, chains, n, vary, P, r_hat, dg, track,
                        nrej, need,
                        nxt, reinterpret_cast<const int4*>(items), nitems, total, cnt, flags,
                        epoch, 0, stamps, nf, Pg};
  return hb::dispatch<hb::TiledSweep>(a, mi, nf, g, static_cast<cudaStream_t>(stream));
}

// The CTAs of a tiled sweep at tiles of B the card holds at once, into
// *out: a launch of `chains` drawers and at least one item CTA needs
// chains + 1 of them (ops/blockgibbs.py runs a larger batch in groups);
// rows_smem 0: the packed rows read from global memory (Pg).
int hb_tiled_resident(int B, int mi, int nf, int guard, int rows_smem, long long* out) {
  const bool g = guard != 0;
  if (!hb::block_ok(B, mi, nf) || (g && mi != 4 && mi != 6)) return cudaErrorInvalidValue;
  const hb::ResidentArgs a{B, nf, rows_smem, out};
  return hb::dispatch<hb::TiledResident>(a, mi, nf, g, nullptr);
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
  const hb::ChainArgs a{W, P, r0, B, reps, vary, out, cycles, nf};
  return hb::dispatch<hb::ChainRun>(a, mi, nf, g, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

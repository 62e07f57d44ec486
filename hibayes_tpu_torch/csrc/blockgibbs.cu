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
//                 same work for K chains that share X: each CTA stages its
//                 tile of X_{b-1} and X_b in shared memory, 32 rows at a time,
//                 once, and serves up to 64 chains from there, so X crosses
//                 memory once per sweep and not once per chain.  Float32 FMAs
//                 on the CUDA cores (f32 means f32: no TF32).
//   draws_kernel  one CTA per group of 8 chains.  Reduces the row-tile
//                 partials in a fixed order (no atomics: a chain is
//                 reproducible run to run), loads W_b (64 KB at B = 128) and
//                 the packed rows into shared memory, then one warp per chain
//                 runs the B sequential draws (draws.cuh).  Bound by the
//                 latency of that dependent chain.
//
// A last rows_kernel applies the final block's changes.  X and W are indexed
// by the GLOBAL block off + b; the packed rows and outputs by the local b
// (sweep_mc_tc reads W by the local block, a TPU-side fault this port does
// not copy).  Any n is taken: the ragged last tile is masked here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"

namespace hb {

constexpr int kChainsPerCta = 8;
constexpr int kDrawWarps = kChainsPerCta;
constexpr int kDrawThreads = kWarp * kDrawWarps;
constexpr int kRowWarps = 32;
constexpr int kRowThreads = kWarp * kRowWarps;
constexpr int kRowUnroll = 4;   // rows in flight per warp (8 spills at 64 registers)

// rows_mc_kernel: 8 warps; a CTA serves up to kMcChains chains (grid.y =
// ceil(K / kMcChains)), warp w the chains w, w + 8, ... (at most
// kMcChains / kMcWarps of them); a chunk is kMcRows rows, one per lane in
// the residual update.
constexpr int kMcWarps = 8;
constexpr int kMcThreads = kWarp * kMcWarps;
constexpr int kMcChains = 64;
constexpr int kMcRows = kWarp;
// (row, 4-column) pieces of one chunk of one X block each thread stages
constexpr int kMcPieces = kMcRows * (kMaxBlock / 4) / kMcThreads;

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

// grid (ntiles, K), kRowThreads threads; tile t holds rows [t * rows_per_tile,
// (t + 1) * rows_per_tile) of n.  A warp takes kRowUnroll rows at a time
// (all their loads in flight together); lane l owns columns 4l .. 4l+3.
// Xprev == nullptr skips the residual update, Xcur == nullptr the partials.
template <typename XT>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const XT* __restrict__ Xprev, const float* __restrict__ dgprev,
            long long dg_stride, const XT* __restrict__ Xcur, int n, int B,
            int rows_per_tile, float* __restrict__ yadj,
            float* __restrict__ u, float* __restrict__ partial) {
  __shared__ float red[kRowWarps][kMaxBlock];
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
  if (partial == nullptr) return;
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

// Shared memory of rows_mc_kernel, in floats: the previous block's dg of
// the CTA's kc chains (kc, B); a chunk of X_{b-1} and of X_b as float
// (kMcRows, B + 4 each: the pitch keeps the lanes' float4 reads of one
// column group in distinct banks); the chunk's updated yadj (kc, kMcRows).
// At kc = 64, B = 128: 32 KB + 2 x 16.5 KB + 8 KB = 74 KB of the 227 KB a
// block may hold, whatever n: the chunk, not the tile, bounds it.
inline size_t rows_mc_smem(int B, int kc) {
  return sizeof(float) * (static_cast<size_t>(kc) * B + 2 * kMcRows * (B + 4) +
                          static_cast<size_t>(kc) * kMcRows);
}

// Stage thread-owned pieces of rows [r0, r0 + kMcRows) of one X block
// (zeros past row_end) into registers: piece p of this thread is
// i = threadIdx.x + p * kMcThreads, row i / (B / 4), columns 4 (i % (B / 4)).
template <typename XT>
__device__ __forceinline__ void load_chunk(const XT* X, int r0, int row_end,
                                           int B, float v[kMcPieces][4]) {
  const int B4 = B / 4;
#pragma unroll
  for (int p = 0; p < kMcPieces; ++p) {
    const int i = threadIdx.x + p * kMcThreads;
    const int r = i / B4;
    v[p][0] = v[p][1] = v[p][2] = v[p][3] = 0.f;
    if (X != nullptr && r < kMcRows && r0 + r < row_end)
      load4(X + static_cast<size_t>(r0 + r) * B + 4 * (i - r * B4), v[p]);
  }
}

__device__ __forceinline__ void store_chunk(float* xs, int B,
                                            const float v[kMcPieces][4]) {
  const int B4 = B / 4;
#pragma unroll
  for (int p = 0; p < kMcPieces; ++p) {
    const int i = threadIdx.x + p * kMcThreads;
    const int r = i / B4;
    if (r < kMcRows)
      *reinterpret_cast<float4*>(xs + r * (B + 4) + 4 * (i - r * B4)) =
          make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
  }
}

// yadj and u (u == nullptr: zeros) of one row for each chain of the warp.
template <int SLOTS>
__device__ __forceinline__ void load_rows(const float* yadj, const float* u, int n,
                                          int k0, int kc, int row, int row_end,
                                          float y[SLOTS], float uu[SLOTS]) {
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int kk = warp + kMcWarps * s;
    const long long at = static_cast<long long>(k0 + kk) * n + row;
    const bool ok = kk < kc && row < row_end;
    y[s] = ok ? yadj[at] : 0.f;
    uu[s] = ok && u != nullptr ? u[at] : 0.f;
  }
}

// grid (ntiles, ceil(K / kMcChains)), kMcThreads threads, dynamic shared
// memory rows_mc_smem(B, min(K - k0, kMcChains)).  Tile t holds rows
// [t * rows_per_tile, (t + 1) * rows_per_tile) of n, walked in chunks of
// kMcRows rows; the next chunk's X is loaded into registers while the
// current one is used.  Per chunk, for every chain k of the CTA:
//   residual update (lane = row, warp w's chains): delta = X_{b-1}[row, :] .
//     dg_{b-1}[k, :], summed over the columns in order; yadj += delta,
//     u -= delta;
//   partial (lane = 4 columns, warp w's chains): acc[k, c] += X_b[row, c]
//     yadj[k, row], over the tile's rows in order.
// Each sum runs in one thread in a fixed order that depends neither on K
// nor on the other chains, so chain k of a K = 8 launch and of a K = 64
// launch is bit for bit the same, and a chain is reproducible run to run.
// Xprev == nullptr skips the residual update, Xcur == nullptr the partials.
// SLOTS (1, 2, 4 or 8) is how many chains a warp serves, ceil(kc / 8)
// rounded up to a power of two: a small batch issues no work for absent
// chains.  A chain's arithmetic is the same whatever SLOTS.
template <typename XT, int SLOTS>
__global__ void __launch_bounds__(kMcThreads)
rows_mc_kernel(const XT* __restrict__ Xprev, const float* __restrict__ dgprev,
               long long dg_stride, const XT* __restrict__ Xcur, int n, int B,
               int rows_per_tile, int K, float* __restrict__ yadj,
               float* __restrict__ u, float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.y * kMcChains;
  const int kc = min(kMcChains, K - k0);
  const int pitch = B + 4;
  float* dgs = smem;                 // (kc, B)
  float* xp = dgs + kc * B;          // (kMcRows, pitch)
  float* xc = xp + kMcRows * pitch;  // (kMcRows, pitch)
  float* ys = xc + kMcRows * pitch;  // (kc, kMcRows)
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = 4 * lane;
  const bool prev = Xprev != nullptr;
  const bool cur = Xcur != nullptr;
  if (prev) {
    for (int i = threadIdx.x; i < kc * B; i += blockDim.x) {
      const int kk = i / B;
      dgs[i] = dgprev[(k0 + kk) * dg_stride + (i - kk * B)];
    }
  }
  const int row_begin = blockIdx.x * rows_per_tile;
  const int row_end = min(n, row_begin + rows_per_tile);
  float acc[SLOTS][4];
  float pv[kMcPieces][4], cv[kMcPieces][4], yn[SLOTS], un[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;

  if (row_begin < row_end) {
    load_chunk(Xprev, row_begin, row_end, B, pv);
    load_chunk(Xcur, row_begin, row_end, B, cv);
    load_rows<SLOTS>(yadj, prev ? u : nullptr, n, k0, kc, row_begin + lane, row_end, yn, un);
  }
  for (int r0 = row_begin; r0 < row_end; r0 += kMcRows) {
    __syncthreads();   // the last chunk's X is read (and dgs is stored)
    if (prev) store_chunk(xp, B, pv);
    if (cur) store_chunk(xc, B, cv);
    float y[SLOTS], uu[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) { y[s] = yn[s]; uu[s] = un[s]; }
    __syncthreads();
    if (r0 + kMcRows < row_end) {   // the next chunk's loads fly meanwhile
      load_chunk(Xprev, r0 + kMcRows, row_end, B, pv);
      load_chunk(Xcur, r0 + kMcRows, row_end, B, cv);
      load_rows<SLOTS>(yadj, prev ? u : nullptr, n, k0, kc, r0 + kMcRows + lane, row_end, yn, un);
    }
    const int row = r0 + lane;
    if (prev) {
      float d[SLOTS];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) d[s] = 0.f;
      const float* xr = xp + lane * pitch;
      for (int c = 0; c < B; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(xr + c);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int kk = warp + kMcWarps * s;
          if (kk < kc) {
            const float4 g = *reinterpret_cast<const float4*>(dgs + kk * B + c);
            d[s] = fmaf(x.x, g.x, d[s]);
            d[s] = fmaf(x.y, g.y, d[s]);
            d[s] = fmaf(x.z, g.z, d[s]);
            d[s] = fmaf(x.w, g.w, d[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int kk = warp + kMcWarps * s;
        if (kk < kc && row < row_end) {
          const long long at = static_cast<long long>(k0 + kk) * n + row;
          y[s] += d[s];
          yadj[at] = y[s];
          u[at] = uu[s] - d[s];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int kk = warp + kMcWarps * s;
      if (kk < kc) ys[kk * kMcRows + lane] = y[s];
    }
    __syncwarp();   // a warp reads back only its own chains' yadj
    if (cur && c0 < B) {
      const int nr = min(kMcRows, row_end - r0);
      for (int r = 0; r < nr; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xc + r * pitch + c0);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int kk = warp + kMcWarps * s;
          if (kk < kc) {
            const float yr = ys[kk * kMcRows + r];
            acc[s][0] = fmaf(x.x, yr, acc[s][0]);
            acc[s][1] = fmaf(x.y, yr, acc[s][1]);
            acc[s][2] = fmaf(x.z, yr, acc[s][2]);
            acc[s][3] = fmaf(x.w, yr, acc[s][3]);
          }
        }
      }
    }
    __syncwarp();
  }
  if (partial == nullptr || c0 >= B) return;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int kk = warp + kMcWarps * s;
    if (kk < kc)
      *reinterpret_cast<float4*>(
          partial + (static_cast<long long>(blockIdx.x) * K + k0 + kk) * B + c0) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
  }
}

inline size_t draws_smem(int B, int R, int K) {
  const size_t kc = K < kChainsPerCta ? K : kChainsPerCta;
  return sizeof(float) * (static_cast<size_t>(B) * B + kc * B * R + kc * B +
                          kDrawWarps * kc * B);
}

// grid ceil(K / kChainsPerCta), kDrawThreads threads, dynamic shared memory
// draws_smem(B, R, K).  partial (ntiles, K, B) holds X_b' yadj in row-tile
// pieces: warp w sums tiles w, w + 8, ... (lane l columns 4l .. 4l+3) and
// the eight sums are added in warp order, a fixed order.  P (B, R, K) holds
// the packed rows of this block; W (B, B) its Gram.  Outputs (any may be
// null) go to out[j * sj + k * sk].
template <int MI, int NF>
__global__ void __launch_bounds__(kDrawThreads)
draws_kernel(const float* __restrict__ partial, int ntiles,
             const float* __restrict__ W, const float* __restrict__ P, int B,
             int K, float* gi_out, float* dg_out, float* tr_out, long long sj,
             long long sk) {
  constexpr int R = packed_rows(MI, NF);
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kChainsPerCta;
  const int kc = min(kChainsPerCta, K - k0);
  const int np = kc * B;
  float* Ws = smem;              // B * B
  float* Ps = Ws + B * B;        // kc * B * R, chain-major
  float* r0s = Ps + kc * B * R;  // kc * B
  float* red = r0s + np;         // kDrawWarps * kc * B
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  if ((reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    const float4* W4 = reinterpret_cast<const float4*>(W);
    float4* Ws4 = reinterpret_cast<float4*>(Ws);
#pragma unroll 4
    for (int i = threadIdx.x; i < B * B / 4; i += blockDim.x) Ws4[i] = W4[i];
  } else {
    for (int i = threadIdx.x; i < B * B; i += blockDim.x) Ws[i] = W[i];
  }
  const int BR = B * R;
  for (int i = threadIdx.x; i < kc * BR; i += blockDim.x) {
    const int w = i / BR;
    Ps[i] = P[static_cast<long long>(i - w * BR) * K + k0 + w];
  }
  const int c0 = 4 * lane;
  if (c0 < B) {
    for (int kk = 0; kk < kc; ++kk) {
      const float* src = partial + static_cast<long long>(k0 + kk) * B + c0;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = warp; t < ntiles; t += kDrawWarps) {
        const float4 x = *reinterpret_cast<const float4*>(
            src + static_cast<long long>(t) * K * B);
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
      }
      *reinterpret_cast<float4*>(red + warp * np + kk * B + c0) = acc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < kDrawWarps; ++w) acc += red[w * np + i];
    r0s[i] = acc;
  }
  __syncthreads();

  if (warp >= kc) return;
  float r[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = lane + kWarp * s;
    r[s] = i < B ? r0s[warp * B + i] : 0.f;
    gi[s] = dg[s] = tr[s] = 0.f;
  }
  warp_block_draws<MI, NF>(B, Ws, Ps + warp * BR, r, gi, dg, tr);
  const long long k = k0 + warp;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + kWarp * s;
    if (j >= B) continue;
    const long long o = j * sj + k * sk;
    if (gi_out != nullptr) gi_out[o] = gi[s];
    if (dg_out != nullptr) dg_out[o] = dg[s];
    if (tr_out != nullptr) tr_out[o] = tr[s];
  }
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
};

template <int MI, int NF>
cudaError_t launch_draws_t(const DrawArgs& a, cudaStream_t stream) {
  const size_t smem = draws_smem(a.B, a.R, a.K);
  cudaError_t e = cudaFuncSetAttribute(
      draws_kernel<MI, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = (a.K + kChainsPerCta - 1) / kChainsPerCta;
  draws_kernel<MI, NF><<<grid, kDrawThreads, smem, stream>>>(
      a.partial, a.ntiles, a.W, a.P, a.B, a.K, a.gi, a.dg, a.tr, a.sj, a.sk);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_draws_launches;
  return e;
}

inline cudaError_t launch_draws(const DrawArgs& a, int mi, int nf,
                                cudaStream_t s) {
  switch (mi) {
    case 1: return launch_draws_t<1, 2>(a, s);
    case 2: return launch_draws_t<2, 2>(a, s);
    case 3: return launch_draws_t<3, 2>(a, s);
    case 4: return launch_draws_t<4, 2>(a, s);
    case 5: return launch_draws_t<5, 2>(a, s);
    default: break;
  }
  switch (nf) {
    case 2: return launch_draws_t<6, 2>(a, s);
    case 3: return launch_draws_t<6, 3>(a, s);
    case 4: return launch_draws_t<6, 4>(a, s);
    case 5: return launch_draws_t<6, 5>(a, s);
    case 6: return launch_draws_t<6, 6>(a, s);
    case 7: return launch_draws_t<6, 7>(a, s);
    case 8: return launch_draws_t<6, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t sweep(const XT* X, const float* W, const float* P, int off,
                  int nbg, int n, int rows_per_tile, int B, int R, int K,
                  int mi, int nf, float* yadj, float* u, float* g_out,
                  float* dg_out, float* tr_out, float* partial,
                  cudaStream_t stream) {
  const int ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  const size_t xblk = static_cast<size_t>(n) * B;
  const long long m_loc = static_cast<long long>(nbg) * B;
  // K = 1: the single-chain rows kernel; K >= 2: the K-chain one, which
  // reads each X tile once for all chains.  One kernel for every batch size
  // keeps chain k's sums the same whatever K.  rows_kernel on a (tiles, K)
  // grid was faster at K = 4, n = 50,176 and slower at K = 64, n = 4,096
  // (scripts/sweep_routes.py, PERF.md): at small K most of the K-chain
  // kernel's warps idle (warp w serves chains w, w + 8, ...).
  const bool mc = K > 1;
  const dim3 rows_grid(ntiles, mc ? (K + kMcChains - 1) / kMcChains : 1);
  const int kc = K < kMcChains ? K : kMcChains;
  const size_t mc_smem = rows_mc_smem(B, kc);
  const int per_warp = (kc + kMcWarps - 1) / kMcWarps;
  void (*rows_mc)(const XT*, const float*, long long, const XT*, int, int, int, int,
                  float*, float*, float*) =
      per_warp <= 1 ? rows_mc_kernel<XT, 1> : per_warp <= 2 ? rows_mc_kernel<XT, 2>
      : per_warp <= 4 ? rows_mc_kernel<XT, 4> : rows_mc_kernel<XT, 8>;
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
    if (mc)
      rows_mc<<<rows_grid, kMcThreads, mc_smem, stream>>>(
          Xp, dgp, m_loc, Xc, n, B, rows_per_tile, K, yadj, u, part);
    else
      rows_kernel<XT><<<rows_grid, kRowThreads, 0, stream>>>(
          Xp, dgp, m_loc, Xc, n, B, rows_per_tile, yadj, u, part);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++(mc ? g_rows_mc_launches : g_rows_launches);
    if (e != cudaSuccess || b == nbg) return e;
    const long long lb = static_cast<long long>(b) * B;
    const DrawArgs a{partial, ntiles,
                     W + static_cast<size_t>(off + b) * B * B,
                     P + static_cast<size_t>(b) * B * R * K, B, R, K,
                     g_out + lb, dg_out + lb, tr_out + lb, 1, m_loc};
    e = launch_draws(a, mi, nf, stream);
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
  const hb::DrawArgs a{r0t, 1, W, P, B, R, K, nullptr, dg, track, K, 1};
  return hb::launch_draws(a, mi, nf, static_cast<cudaStream_t>(stream));
}

// Fused K-chain sweep over blocks [off, off + nbg) of X (nb_tot, n, B) and
// W (nb_tot, B, B).  P (nbg, B, R, K) packed rows; yadj, u (K, n) updated in
// place; g_out, dg_out, track (K, nbg * B) outputs; partial is scratch of
// ceil(n / rows_per_tile) * K * B floats.
int hb_sweep_mc(const void* X, int x_int8, const float* W, const float* P,
                int off, int nbg, int n, int rows_per_tile, int B, int R,
                int K, int mi, int nf, float* yadj, float* u, float* g_out,
                float* dg_out, float* track, float* partial, void* stream) {
  if (!hb::shapes_ok(B, R, K, mi, nf) || n <= 0 || rows_per_tile <= 0 ||
      off < 0 || nbg < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_int8)
    return hb::sweep(static_cast<const int8_t*>(X), W, P, off, nbg, n,
                     rows_per_tile, B, R, K, mi, nf, yadj, u, g_out, dg_out,
                     track, partial, s);
  return hb::sweep(static_cast<const float*>(X), W, P, off, nbg, n,
                   rows_per_tile, B, R, K, mi, nf, yadj, u, g_out, dg_out,
                   track, partial, s);
}

}  // extern "C"

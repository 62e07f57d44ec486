// Hopper kernels of the summary-level (sbrm) blocked-Gibbs sweep.
//
// Built with nvcc into its own shared library with a plain C interface
// (hibayes_tpu_torch/ops/build.py) and called through ctypes
// (hibayes_tpu_torch/ops/blockgibbs.py).  Every entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
//
// They replace the TPU kernels of hibayes_tpu/ops/blockgibbs.py:
//   hb_sweep_s_segment <- _kernel_s / sweep_s_segment        (:1141-1254)
//   hb_sweep_s_tiled   <- _kernel_s_tiled / sweep_s_tiled     (:1635-1792)
//
// The chain state is r_hat, the adjusted X'y.  Per block b of B SNPs the
// TPU kernels draw B effects against the Gram rows n * LD[block, block],
// then add n * LD[:, block] dg to r_hat (SBayesD.cpp:264-267), carrying
// r_hat in VMEM across an in-order grid.  CTAs run in no order here, so a
// sweep is one C loop on one stream, two launches per block:
//
//   s_draws_kernel   one CTA: loads the B x B Gram block scaled by n and the
//                    block's packed rows into shared memory, then warp 0
//                    runs the B dependent draws (draws.cuh), with the
//                    rejection guard for the tiled sweep.
//   seg_update_kernel  (dense segment) r_seg[i] += n sum_j LD[i, bB + j] dg_j
//                    for every row i of the segment: many CTAs, four rows
//                    per warp, each CTA owning distinct rows, so no atomics
//                    and a fixed summation order.
//   tiled_scatter_kernel  (tiled LD) one CTA per stored slot of the tile row:
//                    r_hat[block cols[i, k]] += n tiles[i, k]^T dg.  Within
//                    a row the valid column blocks are distinct, so no two
//                    CTAs write one element.  Invalid slots point at the
//                    row's own block and are skipped: a 0 * upd from them
//                    would race with the diagonal slot's real update.
//
// What bounds them on this card: not device memory (the tiled sweep of the
// m = 500,000 band moves 2.34 GB, 0.70 ms at 3.35 TB/s; a dense segment of
// m = 32,768 4.3 GB, 1.28 ms) but the chain of dependent launches: a
// block's B draws run in one warp, and the next block waits for them and
// for the update they feed.  The overlap below hides each launch's loads
// behind the draw chain before it, not the chain (PERF.md).
//
// Ordering: block b's draws read r_hat only after every earlier block's
// update; the launches sit on one stream, in order.  The packed rows are
// read in the (R, m) layout that pack_rows returns and transposed into
// shared memory.
//
// Overlap (Hopper's programmatic dependent launch): every launch of a sweep
// but the first may start while the launch before it still runs.  Each
// kernel first loads what no earlier launch of the sweep writes (the Gram
// block or tiles, the packed rows, the segment's LD rows), then waits
// (griddepcontrol.wait) until the launch before it has finished and its
// writes are visible, and only then reads r_hat or dg.  A draw launch lets
// its successor start once its own wait is over; an update or scatter
// launch at once.  So the next kernel's loads run beside the current draw
// chain, and at most two launches wait ahead.  The first launch of a sweep
// is an ordinary one: the packed rows it loads come from the kernel before
// it in the stream.
//
// Rounding: the TPU kernels scale inside the draw, dg * n * w (:1179,
// :1693); here W is scaled once on load, so a draw adds dg * (n * w).
// The update adds n * (sum_j w_ij dg_j), as the TPU kernels do (:1192,
// :1709), with the sum in another order.  All in float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"

namespace hb {

constexpr int kSDrawThreads = 256;   // 8 warps load the Gram block; warp 0 draws
constexpr int kUpdWarps = 8;
constexpr int kUpdThreads = kWarp * kUpdWarps;
constexpr int kUpdRows = 4;          // rows in flight per warp
constexpr int kScatterThreads = 256;

// Launches of each kernel, counted where it is launched (hb_s_launch_counts).
long long g_seg_draws = 0, g_seg_update = 0, g_tiled_draws = 0, g_tiled_scatter = 0;

// Wait until the launch before this one has finished and its writes are
// visible (a no-op for an ordinary launch).
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Let the next launch of the stream start (if it allows overlap).
__device__ __forceinline__ void release_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launch `kernel` on `stream`; with `overlap` it may start before the
// kernel before it has finished (it must wait_previous() before reading
// that kernel's output).
template <typename... P, typename... A>
cudaError_t launch(bool overlap, void (*kernel)(P...), int grid, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = overlap ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One block of B draws.  W: the block's B x B Gram rows with row stride ldw
// (unscaled LD), scaled by n on load.  P: packed rows (R, m); the block's
// SNPs are columns col0 .. col0 + B - 1, as are its entries of r, dg and tr.
// nrej (may be null) gets the count of draws whose first candidate the
// guard rejected.
template <int MI, int NF, bool GUARD>
__global__ void __launch_bounds__(kSDrawThreads)
s_draws_kernel(const float* __restrict__ W, long long ldw, float n,
               const float* __restrict__ P, long long m, long long col0, int B,
               const float* __restrict__ r, float vary, float* __restrict__ dg_out,
               float* __restrict__ tr_out, int* __restrict__ nrej) {
  constexpr int R = row_stride(MI, NF, GUARD);
  extern __shared__ float smem[];
  float* Ws = smem;           // B * B
  float* Ps = Ws + B * B;     // B * R, SNP-major
  const int B4 = B / 4;
  for (int i = threadIdx.x; i < B * B4; i += blockDim.x) {
    const int a = i / B4, c = 4 * (i - a * B4);
    float4 w = *reinterpret_cast<const float4*>(W + a * ldw + c);
    w.x *= n; w.y *= n; w.z *= n; w.w *= n;
    *reinterpret_cast<float4*>(Ws + a * B + c) = w;
  }
  for (int i = threadIdx.x; i < B * R; i += blockDim.x) {
    const int row = i / B, j = i - row * B;
    Ps[j * R + row] = P[row * m + col0 + j];
  }
  __syncthreads();
  if (threadIdx.x >= kWarp) return;
  wait_previous();   // the previous update of r is visible from here
  release_next();
  const int lane = threadIdx.x;
  float rr[kSlots], gi[kSlots], dg[kSlots], tr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = lane + kWarp * s;
    rr[s] = i < B ? r[col0 + i] : 0.f;
    gi[s] = dg[s] = tr[s] = 0.f;
  }
  const int rej = warp_block_draws<MI, NF, GUARD>(B, Ws, Ps, rr, gi, dg, tr, vary);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + kWarp * s;
    if (j < B) {
      dg_out[col0 + j] = dg[s];
      tr_out[col0 + j] = tr[s];
    }
  }
  if (nrej != nullptr && lane == 0) *nrej = rej;
}

// r[i] += n * sum_j LD[i, col0 + j] dg[col0 + j] for i in [0, mc).  Warp w of
// CTA c takes rows (c * kUpdWarps + w) * kUpdRows + v, v < kUpdRows, all
// loads in flight together (before the wait for the draws); lane l owns
// columns 4l .. 4l + 3 (B <= 128).
__global__ void __launch_bounds__(kUpdThreads)
seg_update_kernel(const float* __restrict__ LD, long long mc, long long col0,
                  int B, float n, const float* __restrict__ dg,
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
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owns) d = *reinterpret_cast<const float4*>(dg + col0 + c0);
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
      if (row0 + v < mc) r[row0 + v] += n * part[v];
  }
}

// CTA k: if valid[k], r_hat[cols[k] * B + c] += n * sum_a T_k[a, c] dg[a]
// for the tile T_k (B x B, row-major).  Warp w holds the rows a = w, w + 8,
// ... (lane l columns 4l .. 4l + 3) in registers, loaded before the wait
// for the draws; the eight warp sums are added in warp order.
__global__ void __launch_bounds__(kScatterThreads)
tiled_scatter_kernel(const float* __restrict__ tiles, const int* __restrict__ cols,
                     const int* __restrict__ valid, int B, float n,
                     const float* __restrict__ dg, float* __restrict__ r_hat) {
  constexpr int kW = kScatterThreads / kWarp;
  constexpr int kRows = kMaxBlock / kW;   // tile rows per warp
  __shared__ float red[kW][kMaxBlock];
  __shared__ float dgs[kMaxBlock];
  release_next();
  const int k = blockIdx.x;
  if (!valid[k]) return;   // uniform across the CTA
  const float* T = tiles + static_cast<long long>(k) * B * B;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = 4 * lane;
  float4 x[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int a = warp + kW * t;
    x[t] = (c0 < B && a < B) ? *reinterpret_cast<const float4*>(T + a * B + c0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  wait_previous();   // dg of this tile row is visible from here
  for (int i = threadIdx.x; i < B; i += blockDim.x) dgs[i] = dg[i];
  __syncthreads();
  if (c0 < B) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int a = warp + kW * t;
      const float da = a < B ? dgs[a] : 0.f;
      acc[0] += x[t].x * da; acc[1] += x[t].y * da; acc[2] += x[t].z * da; acc[3] += x[t].w * da;
    }
    for (int q = 0; q < 4; ++q) red[warp][c0 + q] = acc[q];
  }
  __syncthreads();
  float* rb = r_hat + static_cast<long long>(cols[k]) * B;
  for (int c = threadIdx.x; c < B; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kW; ++w) s += red[w][c];
    rb[c] += n * s;
  }
}

inline bool block_ok(int B, int mi, int nf) {
  return B > 0 && B <= kMaxBlock && B % 4 == 0 && mi >= 1 && mi <= 6 &&
         nf >= 2 && nf <= kMaxFold;
}

template <int MI, int NF, bool GUARD>
cudaError_t set_draw_smem(int B) {
  const size_t smem = sizeof(float) * static_cast<size_t>(B) * (B + row_stride(MI, NF, GUARD));
  return cudaFuncSetAttribute(s_draws_kernel<MI, NF, GUARD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct SegArgs {
  const float* LD;
  const float* P;
  int mc, B;
  float n;
  float *r, *dg, *tr;
};

template <int MI, int NF, bool GUARD>
cudaError_t seg_sweep(const SegArgs& a, cudaStream_t stream) {
  cudaError_t e = set_draw_smem<MI, NF, GUARD>(a.B);
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * static_cast<size_t>(a.B) * (a.B + row_stride(MI, NF, GUARD));
  const long long mc = a.mc;
  const int upd_grid = static_cast<int>((mc + kUpdWarps * kUpdRows - 1) / (kUpdWarps * kUpdRows));
  for (long long col0 = 0; col0 < mc; col0 += a.B) {
    e = launch(col0 > 0, s_draws_kernel<MI, NF, GUARD>, 1, kSDrawThreads, smem, stream,
               a.LD + col0 * mc + col0, mc, a.n, a.P, mc, col0, a.B,
               static_cast<const float*>(a.r), 0.f, a.dg, a.tr, static_cast<int*>(nullptr));
    if (e != cudaSuccess) return e;
    ++g_seg_draws;
    e = launch(true, seg_update_kernel, upd_grid, kUpdThreads, 0, stream, a.LD, mc,
               col0, a.B, a.n, static_cast<const float*>(a.dg), a.r);
    if (e != cudaSuccess) return e;
    ++g_seg_update;
  }
  return cudaSuccess;
}

struct TiledArgs {
  const float* tiles;
  const int* cols;
  const int* valid;
  int nbr, K, B;
  float n, vary;
  const float* P;
  float *r_hat, *dg, *tr;
  int* nrej;
};

template <int MI, int NF, bool GUARD>
cudaError_t tiled_sweep(const TiledArgs& a, cudaStream_t stream) {
  cudaError_t e = set_draw_smem<MI, NF, GUARD>(a.B);
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * static_cast<size_t>(a.B) * (a.B + row_stride(MI, NF, GUARD));
  const long long m_pad = static_cast<long long>(a.nbr) * a.B;
  const long long row_elems = static_cast<long long>(a.K) * a.B * a.B;
  for (int i = 0; i < a.nbr; ++i) {
    const float* Ti = a.tiles + i * row_elems;   // slot 0: the diagonal tile
    const long long col0 = static_cast<long long>(i) * a.B;
    e = launch(i > 0, s_draws_kernel<MI, NF, GUARD>, 1, kSDrawThreads, smem, stream,
               Ti, static_cast<long long>(a.B), a.n, a.P, m_pad, col0, a.B,
               static_cast<const float*>(a.r_hat), a.vary, a.dg, a.tr, a.nrej + i);
    if (e != cudaSuccess) return e;
    ++g_tiled_draws;
    e = launch(true, tiled_scatter_kernel, a.K, kScatterThreads, 0, stream, Ti,
               a.cols + static_cast<long long>(i) * a.K,
               a.valid + static_cast<long long>(i) * a.K, a.B, a.n,
               static_cast<const float*>(a.dg + col0), a.r_hat);
    if (e != cudaSuccess) return e;
    ++g_tiled_scatter;
  }
  return cudaSuccess;
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

}  // namespace hb

extern "C" {

const char* hb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches since the last reset: segment draws, segment updates, tiled
// draws, tiled scatters.
void hb_s_launch_counts(long long* out) {
  out[0] = hb::g_seg_draws;
  out[1] = hb::g_seg_update;
  out[2] = hb::g_tiled_draws;
  out[3] = hb::g_tiled_scatter;
}

void hb_s_reset_launch_counts() {
  hb::g_seg_draws = hb::g_seg_update = hb::g_tiled_draws = hb::g_tiled_scatter = 0;
}

// Sweep one dense LD segment.  LD (mc, mc) row-major; P (R, mc) packed rows;
// r (mc,) updated in place; dg, track (mc,) outputs.  mc % B == 0; LD, P, r
// and dg 16-byte aligned.
int hb_sweep_s_segment(const float* LD, const float* P, int mc, int B, int R,
                       int mi, int nf, float n, float* r, float* dg,
                       float* track, void* stream) {
  if (!hb::block_ok(B, mi, nf) || mc <= 0 || mc % B != 0 ||
      R != hb::packed_rows(mi, nf))
    return cudaErrorInvalidValue;
  const hb::SegArgs a{LD, P, mc, B, n, r, dg, track};
  return hb::dispatch<hb::SegSweep>(a, mi, nf, false, static_cast<cudaStream_t>(stream));
}

// Sweep every tile row of a tiled LD.  tiles (nbr, K, B, B); cols, valid
// (nbr, K) int32; P (R, nbr * B) packed rows (with the guard rows when
// guard); r_hat (nbr * B,) updated in place; dg, track (nbr * B,) and nrej
// (nbr,) outputs.
int hb_sweep_s_tiled(const float* tiles, const int* cols, const int* valid,
                     int nbr, int K, int B, int R, int mi, int nf, int guard,
                     float n, float vary, const float* P, float* r_hat,
                     float* dg, float* track, int* nrej, void* stream) {
  const bool g = guard != 0;
  if (!hb::block_ok(B, mi, nf) || nbr <= 0 || K <= 0 ||
      (g && mi != 4 && mi != 6) || R != hb::row_stride(mi, nf, g))
    return cudaErrorInvalidValue;
  const hb::TiledArgs a{tiles, cols, valid, nbr, K, B, n, vary, P, r_hat, dg, track, nrej};
  return hb::dispatch<hb::TiledSweep>(a, mi, nf, g, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

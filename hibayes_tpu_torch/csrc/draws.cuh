// Sequential SNP draws of one block for one chain, held by one warp.
//
// This is the draw stage that the TPU kernels share (_unrolled_draws +
// _draw_from_vals, hibayes_tpu/ops/blockgibbs.py:537-639), used by the
// Hopper kernels in blockgibbs.cu and sgibbs.cu.  With GUARD it also applies
// the SBayesS rejection guard of the tiled summary kernel
// (_kernel_s_tiled, hibayes_tpu/ops/blockgibbs.py:1672-1686), which the
// summary sweeps run on every SBayesS layout (tiled and dense segments).
//
// What bounds it on the card: latency.  The B draws of a block form one
// dependent chain (draw j reads every earlier draw's correction through the
// Gram block), so no amount of parallel hardware shortens it.  The design
// keeps the chain inside one warp and keeps every load off it:
//   - lane l owns SNPs 4l .. 4l+3 (r_local in registers), so draw j's Gram
//     row is one conflict-free 16-byte shared load a lane from the
//     row-major block every caller stages, and the correction
//     r_local += dg_j * W_b[j, :] one 4-wide register axpy;
//   - every lane evaluates the draw redundantly (no broadcast needed), with
//     draw j's rhs taken by one shuffle from lane j >> 2, slot j & 3 (a
//     compile-time slot under the loop's 4-way unroll);
//   - the packed rows are staged at a stride padded to 4 floats and read as
//     float4; a register ring holds the packed row, the Gram-row slice and
//     W[j, j-1] of the next two draws, loaded two draws ahead, so no shared
//     load sits between two draws;
//   - the SBayesS guard's predicate is part of the common path; its retries
//     run out of line (a warp-uniform branch, taken rarely) and stop at the
//     first accepted candidate.
// No __syncthreads sits on the chain.  The model and fold count are template
// parameters, so each draw is straight-line code.  BayesR with more than
// kMaxFold folds runs one more instance, NF = 0, that takes the fold count
// at run time and spreads each draw's folds over the lanes, a fold a lane,
// its rows loaded one draw ahead (warp_block_draws_rt): the same draws.
#pragma once

#include <cuda_runtime.h>

namespace hb {

constexpr int kWarp = 32;
constexpr int kMaxBlock = 128;                 // SNPs per block (4 per lane)
constexpr int kSlots = kMaxBlock / kWarp;      // SNPs a lane owns: kSlots l + s
constexpr int kMaxFold = 8;                    // BayesR folds compiled in (R <= 31)
constexpr int kRuntimeFold = 0;                // NF of the instance that takes nf at run time
constexpr int kRetry = 8;                      // guard retries (N_RETRY)

// Whether a kernel instance may read the packed rows from global memory
// (its Pg argument): only the run-time fold instance, the one whose rows
// can overflow shared memory; every compiled-fold instance keeps its code
// free of that path (the shared-memory draws as they were).
template <int NF>
__host__ __device__ constexpr bool rows_may_be_global() { return NF == kRuntimeFold; }

// Whether a launch may pass its rows in global memory: it runs the
// run-time fold instance (BayesR above kMaxFold folds).
__host__ __device__ constexpr bool global_rows_ok(int mi, int nf) {
  return mi == 6 && nf > kMaxFold;
}

// Packed rows per SNP (ops/blockgibbs.py:n_rows).
__host__ __device__ constexpr int packed_rows(int mi, int nf) {
  return (mi == 3 || mi == 4) ? 5 : (mi == 6 ? 3 + 4 * (nf - 1) : 4);
}

// Guard rows after the packed rows (ops/blockgibbs.py:pack_retry_rows):
// vx, then kRetry pre-drawn sd * z (BayesC) or kRetry x (nf - 1) per-fold
// sd_f * z (BayesR).  Only models 4 and 6 have a guard.
__host__ __device__ constexpr int guard_rows(int mi, int nf) {
  return mi == 4 ? 1 + kRetry : (mi == 6 ? 1 + kRetry * (nf - 1) : 0);
}

// Rows per SNP: the packed rows, and the guard rows with GUARD.
__host__ __device__ constexpr int row_stride(int mi, int nf, bool guard) {
  return packed_rows(mi, nf) + (guard ? guard_rows(mi, nf) : 0);
}

// Floats per SNP where the rows are staged in shared memory: row_stride
// rounded up to 4, so each SNP's rows start 16-byte aligned and a draw
// reads them as float4 (ops/blockgibbs.py:padded_stride).  The padding is
// never read as a value.
__host__ __device__ constexpr int padded_stride(int r) { return (r + 3) & ~3; }

// One draw over the SNP's packed row p (the R values _pack_rows builds:
// rg, g_old, then per model).  rhs = X_j' yadj_current + rg.  Returns the
// new effect and writes the mixture component.  Arithmetic and tie rules
// are _draw_from_vals': RR/A linear; B/C the exp-free spike/slab test
// rhs^2 >= thresh; L the 1e-6 floor, zero where inv_v == 0; R the
// Gumbel-max fold choice, where a later fold wins only on a strict '>' (the
// TPU's balanced tournament also keeps the lowest index among equal maxima).
template <int MI, int NF>
__device__ __forceinline__ float draw_one(const float* p, float rhs,
                                          float* track) {
  if constexpr (MI == 1 || MI == 2) {
    *track = 0.f;
    return rhs * p[2] + p[3];
  } else if constexpr (MI == 3 || MI == 4) {
    const bool ind = rhs * rhs >= p[4];
    *track = ind ? 1.f : 0.f;
    return ind ? rhs * p[2] + p[3] : 0.f;
  } else if constexpr (MI == 5) {
    float gi = rhs * p[2] + p[3];
    if (fabsf(gi) < 1e-6f) gi = 1e-6f;
    if (!(p[2] > 0.f)) gi = 0.f;
    *track = 0.f;
    return gi;
  } else {
    const float q = rhs * rhs;
    float best = p[2 + 4 * (NF - 1)] + 0.f * rhs;  // fold-0 Gumbel logit
    float gi = 0.f;
    int ind = 0;
#pragma unroll
    for (int f = 1; f < NF; ++f) {
      const float* pf = p + 2 + 4 * (f - 1);
      const float sf = pf[0] + pf[1] * q;
      const float gf = rhs * pf[2] + pf[3];
      if (sf > best) {
        best = sf;
        gi = gf;
        ind = f;
      }
    }
    *track = static_cast<float>(ind);
    return gi;
  }
}

// The SBayesS rejection guard's retries (_kernel_s_tiled :1672-1686) for a
// draw whose first candidate was rejected (gi^2 vx > vary with a nonzero
// component): the kRetry pre-drawn candidates in turn (BayesC:
// rhs inv_v + sd z_t; BayesR: the candidate of the drawn fold tr), the
// first that passes, else 0.  The kernel this ports runs all kRetry and
// keeps a candidate once one passes, so stopping there gives the same gi.
// Out of line: the common path pays only for the predicate.  p is the
// SNP's staged rows (the guard rows from packed_rows on).  Returns {gi,
// 1 when all kRetry candidates failed (gi = 0), else 0}.
template <int MI, int NF>
__device__ __noinline__ float2 guard_retry(const float* p, float rhs, float tr,
                                           float vary, float vxj, int nf = NF) {
  const int nfr = NF == kRuntimeFold ? nf : NF;
  const float* pg = p + packed_rows(MI, nfr);
#pragma unroll 1
  for (int t = 0; t < kRetry; ++t) {
    float cand = 0.f;
    if constexpr (MI == 4) {
      cand = rhs * p[2] + pg[1 + t];
    } else if constexpr (NF == kRuntimeFold) {
      const int f = static_cast<int>(tr);   // the drawn fold, 1 .. nf - 1
      cand = rhs * p[4 + 4 * (f - 1)] + pg[1 + t * (nfr - 1) + (f - 1)];
    } else {
#pragma unroll
      for (int f = 1; f < NF; ++f)
        if (tr == static_cast<float>(f))
          cand = rhs * p[4 + 4 * (f - 1)] + pg[1 + t * (NF - 1) + (f - 1)];
    }
    if (!(cand * cand * vxj > vary)) return make_float2(cand, 0.f);
  }
  return make_float2(0.f, 1.f);
}

// warp_block_draws returns rejected + (exhausted << kExhaustShift): the
// draws whose first candidate the guard rejected, and of those the ones
// whose kRetry candidates all failed (B <= kMaxBlock keeps both below 2^16).
constexpr int kExhaustShift = 16;

// A logit's order as an unsigned key: the larger float, the larger key, -0
// and +0 one key (float comparison holds them equal); NaN takes key 0,
// below every number, since a NaN logit never passes draw_one's strict '>'.
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return x != x ? 0u : ((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

// What a draw of the run-time fold chain reads, loaded one draw ahead.
struct RtRows {
  float2 fa, fb;   // this lane's fold: its logit's two rows, its effect's two
  float p0, p1;    // rg, g_old
  float l0;        // fold 0's logit
  float vx;        // the guard's vx (with GUARD)
  float4 w4;       // this lane's slice of the Gram row
  float wp;        // W[j, j - 1]
};

// warp_block_draws for the NF = kRuntimeFold instance (BayesR with nf folds
// at run time).  Lanes own the same SNPs and the chain between draws is
// warp_block_draws', but a draw's folds are spread over the lanes: lane l
// evaluates fold l + 1 (and l + 33, l + 65, ... above 33 folds) from its
// own packed-row values, loaded one draw ahead with the draw's other
// values, and the warp takes the largest logit, the lowest fold among equal
// ones, by two reductions (__reduce_max_sync of order_key, then
// __reduce_min_sync of the folds that hold it); fold 0 keeps the draw
// unless that logit beats its own.  Each logit and effect is draw_one's
// float expression, and the fold chosen is draw_one's (the first strict
// maximum over folds 0 .. nf - 1), so the outputs are those of the serial
// scan in draw_one, whatever nf.
template <int MI, bool GUARD, bool SCALE>
__device__ __forceinline__ int warp_block_draws_rt(
    int B, int nf, const float* Ws, const float* Ps, float r[kSlots],
    float gi_out[kSlots], float dg_out[kSlots], float tr_out[kSlots], float vary,
    float wscale) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kNone = 0x7fffffff;
  const int R = packed_rows(MI, nf);
  const int RP = padded_stride(row_stride(MI, nf, GUARD));
  const int lane = threadIdx.x % kWarp;
  const int c0 = kSlots * lane;
  const bool owns = c0 < B;
  const bool folds = lane + 1 < nf;   // the lane evaluates fold lane + 1
  const int of = 2 + 4 * lane;        // its rows in a SNP's packed row (8-byte aligned)
  const int o0 = 2 + 4 * (nf - 1);    // fold 0's logit
  auto fetch = [&](int j) {
    const float* p = Ps + j * RP;
    RtRows x;
    x.fa = folds ? *reinterpret_cast<const float2*>(p + of) : make_float2(0.f, 0.f);
    x.fb = folds ? *reinterpret_cast<const float2*>(p + of + 2) : make_float2(0.f, 0.f);
    x.p0 = p[0];
    x.p1 = p[1];
    x.l0 = p[o0];
    x.vx = GUARD ? p[R] : 0.f;
    const float* wrow = Ws + j * B;
    x.w4 = owns ? *reinterpret_cast<const float4*>(wrow + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
    x.wp = wrow[j > 0 ? j - 1 : 0];
    return x;
  };
  RtRows nx = fetch(0);
  float v = __shfl_sync(kAll, r[0], 0);  // r_local[0]
  float dg_prev = 0.f;
  int nrej = 0, nexh = 0;
#pragma unroll 1
  for (int j0 = 0; j0 < B; j0 += kSlots) {
#pragma unroll
    for (int jj = 0; jj < kSlots; ++jj) {
      const int j = j0 + jj;
      const RtRows c = nx;
      nx = fetch(j + 1 < B ? j + 1 : j);   // ahead of the chain
      const float w_prev = SCALE ? wscale * c.wp : c.wp;
      const float rhs = (j > 0 ? v + dg_prev * w_prev : v) + c.p0;
      const float v_next = __shfl_sync(kAll, r[(jj + 1) % kSlots], (j + 1) >> 2);
      const float q = rhs * rhs;
      // this lane's folds: the largest logit, the lowest fold among equal ones
      unsigned key = 0u;
      int fold = kNone;
      float s = 0.f, g = 0.f;
      if (folds) {
        s = c.fa.x + c.fa.y * q;
        g = rhs * c.fb.x + c.fb.y;
        key = order_key(s);
        fold = lane + 1;
#pragma unroll 1
        for (int f = lane + 1 + kWarp; f < nf; f += kWarp) {
          const float* pf = Ps + j * RP + 2 + 4 * (f - 1);
          const float sf = pf[0] + pf[1] * q;
          const unsigned kf = order_key(sf);
          if (kf > key) {
            key = kf;
            fold = f;
            s = sf;
            g = rhs * pf[2] + pf[3];
          }
        }
      }
      const unsigned kmax = __reduce_max_sync(kAll, key);
      const int w = __reduce_min_sync(kAll, key == kmax ? fold : kNone);
      const float sw = __shfl_sync(kAll, s, (w - 1) & (kWarp - 1));
      const float gw = __shfl_sync(kAll, g, (w - 1) & (kWarp - 1));
      const bool take = sw > c.l0 + 0.f * rhs;   // fold 0's logit, as draw_one's
      float gi = take ? gw : 0.f;
      const float tr = take ? static_cast<float>(w) : 0.f;
      if constexpr (GUARD) {
        if ((gi * gi * c.vx > vary) && tr > 0.f) {   // uniform across the warp
          const float2 rc = guard_retry<MI, kRuntimeFold>(Ps + j * RP, rhs, tr, vary, c.vx, nf);
          gi = rc.x;
          ++nrej;
          nexh += rc.y != 0.f;
        }
      }
      const float dg = c.p1 - gi;
      const float4 w4 = c.w4;
      if constexpr (SCALE) {
        r[0] += dg * (wscale * w4.x); r[1] += dg * (wscale * w4.y);
        r[2] += dg * (wscale * w4.z); r[3] += dg * (wscale * w4.w);
      } else {
        r[0] += dg * w4.x; r[1] += dg * w4.y; r[2] += dg * w4.z; r[3] += dg * w4.w;
      }
      if (lane == (j >> 2)) {
        gi_out[jj] = gi;
        dg_out[jj] = dg;
        tr_out[jj] = tr;
      }
      v = v_next;
      dg_prev = dg;
    }
  }
  return nrej + (nexh << kExhaustShift);
}

// The B sequential draws of one chain, run by one whole warp.
//   r[s]  in: r_local[kSlots lane + s] = X_b' yadj at block start
//   Ws    (B, B) Gram block in shared memory, row-major (symmetric),
//         16-byte aligned; with SCALE its entries are multiplied by wscale
//         where they are read (the same float32 product as a block scaled
//         beforehand, off the chain: the Gram row is read ahead of the draw)
//   Ps    (B, padded_stride(R)) rows of this chain in shared memory, 16-byte
//         aligned, R = row_stride(MI, NF, GUARD)
//   vary  the guard's bound (read only with GUARD)
//   nf    the fold count, read only by the NF = kRuntimeFold instance
// B is a multiple of 4.  On return lane l holds, for j = kSlots l + s:
// gi[s], dg[s] = g_old - gi, tr[s] (the mixture component).  Returns the
// number of draws whose first candidate the guard rejected, plus those
// whose every candidate failed shifted by kExhaustShift (0 without GUARD).
//
// The shuffle that fetches draw j+1's r_local runs beside draw j: it reads
// r_local before dg_j is folded in, and draw j+1 adds dg_j * W[j+1, j]
// itself, so the chain from one draw to the next is the draw's arithmetic
// and one multiply-add.  Every float operation, its operands and its order
// are those of the lane-strided design this replaced (lane l owning
// l + 32 s), so the outputs are bit for bit the same.
template <int MI, int NF, bool GUARD = false, bool SCALE = false>
__device__ __forceinline__ int warp_block_draws(
    int B, const float* Ws, const float* Ps, float r[kSlots],
    float gi_out[kSlots], float dg_out[kSlots], float tr_out[kSlots],
    float vary = 0.f, float wscale = 1.f, int nf = NF) {
  static_assert(!GUARD || MI == 4 || MI == 6, "the guard is for BayesC and BayesR");
  static_assert(kSlots == 4, "a lane owns one float4 of a Gram row");
  static_assert(NF != kRuntimeFold || MI == 6, "only BayesR takes a fold count at run time");
  if constexpr (NF == kRuntimeFold) {
    return warp_block_draws_rt<MI, GUARD, SCALE>(B, nf, Ws, Ps, r, gi_out, dg_out, tr_out,
                                                 vary, wscale);
  } else {
  constexpr int R = packed_rows(MI, NF);
  constexpr int RP = padded_stride(row_stride(MI, NF, GUARD));
  constexpr int NV = (R + (GUARD ? 1 : 0) + 3) / 4;   // float4s a draw reads
  constexpr int D = 2;                                // ring depth (draws ahead)
  const int lane = threadIdx.x % kWarp;
  const int c0 = kSlots * lane;
  const bool owns = c0 < B;
  float4 pv[D][NV], wv[D];
  float wp[D];
  // draw j's packed row, Gram-row slice and W[j, j - 1] into ring slot q
  auto fetch = [&](int q, int j) {
    const float4* p4 = reinterpret_cast<const float4*>(Ps + j * RP);
#pragma unroll
    for (int v = 0; v < NV; ++v) pv[q][v] = p4[v];
    const float* wrow = Ws + j * B;
    wv[q] = owns ? *reinterpret_cast<const float4*>(wrow + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
    wp[q] = wrow[j > 0 ? j - 1 : 0];
  };
  fetch(0, 0);
  fetch(1, B > 1 ? 1 : 0);
  float v = __shfl_sync(0xffffffffu, r[0], 0);  // r_local[0]
  float dg_prev = 0.f;
  int nrej = 0, nexh = 0;
#pragma unroll 1
  for (int j0 = 0; j0 < B; j0 += kSlots) {
#pragma unroll
    for (int jj = 0; jj < kSlots; ++jj) {
      const int j = j0 + jj;
      const int q = jj % D;
      float p[4 * NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        p[4 * e] = pv[q][e].x; p[4 * e + 1] = pv[q][e].y;
        p[4 * e + 2] = pv[q][e].z; p[4 * e + 3] = pv[q][e].w;
      }
      const float4 w4 = wv[q];
      const float w_prev = SCALE ? wscale * wp[q] : wp[q];
      fetch(q, j + D < B ? j + D : B - 1);   // ahead of the chain
      const float rhs = (j > 0 ? v + dg_prev * w_prev : v) + p[0];
      // draw j + 1's r_local, before dg_j is folded in (lane (j+1) >> 2 holds it)
      const float v_next = __shfl_sync(0xffffffffu, r[(jj + 1) % kSlots], (j + 1) >> 2);
      float tr;
      float gi = draw_one<MI, NF>(p, rhs, &tr);
      if constexpr (GUARD) {
        const float vxj = p[R];
        if ((gi * gi * vxj > vary) && tr > 0.f) {   // uniform: every lane holds the same values
          const float2 rc = guard_retry<MI, NF>(Ps + j * RP, rhs, tr, vary, vxj);
          gi = rc.x;
          ++nrej;
          nexh += rc.y != 0.f;
        }
      }
      const float dg = p[1] - gi;
      if constexpr (SCALE) {
        r[0] += dg * (wscale * w4.x); r[1] += dg * (wscale * w4.y);
        r[2] += dg * (wscale * w4.z); r[3] += dg * (wscale * w4.w);
      } else {
        r[0] += dg * w4.x; r[1] += dg * w4.y; r[2] += dg * w4.z; r[3] += dg * w4.w;
      }
      if (lane == (j >> 2)) {
        gi_out[jj] = gi;
        dg_out[jj] = dg;
        tr_out[jj] = tr;
      }
      v = v_next;
      dg_prev = dg;
    }
  }
  return nrej + (nexh << kExhaustShift);
  }
}

}  // namespace hb

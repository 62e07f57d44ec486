// Sequential SNP draws of one block for one chain, held by one warp.
//
// This is the draw stage that the TPU kernels share (_unrolled_draws +
// _draw_from_vals, hibayes_tpu/ops/blockgibbs.py:537-639), used by the
// Hopper kernels in blockgibbs.cu and sgibbs.cu.  With GUARD it also applies
// the SBayesS rejection guard of the tiled summary kernel
// (_kernel_s_tiled, hibayes_tpu/ops/blockgibbs.py:1672-1686).
//
// What bounds it on the card: latency.  The B draws of a block form one
// dependent chain (draw j reads every earlier draw's correction through the
// Gram block), so no amount of parallel hardware shortens it.  The design
// keeps the chain inside one warp: lane l holds r_local[l + 32 s] in
// registers, draw j takes its rhs with one shuffle from the owning lane,
// every lane evaluates the draw redundantly (no broadcast needed), and the
// correction r_local += dg_j * W_b[j, :] is one 4-wide register axpy per
// lane reading a conflict-free shared-memory row.  No __syncthreads sits on
// the chain.  The model and fold count are template parameters, so each
// draw is straight-line code.
#pragma once

#include <cuda_runtime.h>

namespace hb {

constexpr int kWarp = 32;
constexpr int kMaxBlock = 128;                 // SNPs per block (4 per lane)
constexpr int kSlots = kMaxBlock / kWarp;
constexpr int kMaxFold = 8;                    // BayesR folds -> R <= 31
constexpr int kRetry = 8;                      // guard retries (N_RETRY)

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

// Rows per SNP in shared memory: the packed rows, and the guard rows with GUARD.
__host__ __device__ constexpr int row_stride(int mi, int nf, bool guard) {
  return packed_rows(mi, nf) + (guard ? guard_rows(mi, nf) : 0);
}

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

// The SBayesS rejection guard on one draw (_kernel_s_tiled :1672-1686): a
// draw with gi^2 vx > vary and a nonzero component takes the next of the
// kRetry pre-drawn candidates (BayesC: rhs inv_v + sd z_t; BayesR: the
// candidate of the drawn fold) until one passes, else 0.  Every lane holds
// the same values, so the branch is uniform across the warp.  Returns
// whether the first draw was rejected.
template <int MI, int NF>
__device__ __forceinline__ bool guard_draw(const float* p, float rhs, float tr,
                                           float vary, float* gi) {
  const float* pg = p + packed_rows(MI, NF);
  const float vxj = pg[0];
  const bool on = tr > 0.f;
  bool rej = (*gi * *gi * vxj > vary) && on;
  const bool first = rej;
  if (rej) {
#pragma unroll
    for (int t = 0; t < kRetry; ++t) {
      float cand = 0.f;
      if constexpr (MI == 4) {
        cand = rhs * p[2] + pg[1 + t];
      } else {
#pragma unroll
        for (int f = 1; f < NF; ++f)
          if (tr == static_cast<float>(f))
            cand = rhs * p[4 + 4 * (f - 1)] + pg[1 + t * (NF - 1) + (f - 1)];
      }
      if (rej) *gi = cand;
      rej = (*gi * *gi * vxj > vary) && on;
    }
    if (rej) *gi = 0.f;
  }
  return first;
}

// The B sequential draws of one chain, run by one whole warp.
//   r[s]  in: r_local[lane + 32 s] = X_b' yadj at block start
//   Ws    (B, B) Gram block in shared memory, row-major (symmetric); with
//         SCALE its entries are multiplied by wscale where they are read
//         (the same float32 product as a block scaled beforehand, off the
//         chain: the Gram row is read ahead of the draw)
//   Ps    (B, R) packed rows of this chain in shared memory,
//         R = row_stride(MI, NF, GUARD)
//   vary  the guard's bound (read only with GUARD)
// On return lane l holds, for j = l + 32 s: gi[s], dg[s] = g_old - gi,
// tr[s] (the mixture component).  Returns the number of draws whose first
// candidate the guard rejected (0 without GUARD).
//
// The shuffle that fetches draw j+1's r_local runs beside draw j: it reads
// r_local before dg_j is folded in, and draw j+1 adds dg_j * W[j+1, j]
// itself, so the chain from one draw to the next is the draw's arithmetic
// and one multiply-add.  Eight draws are unrolled at a time, so the
// packed-row and Gram-row loads of the next draws, which do not depend on
// the chain, start ahead of it.
template <int MI, int NF, bool GUARD = false, bool SCALE = false>
__device__ __forceinline__ int warp_block_draws(
    int B, const float* Ws, const float* Ps, float r[kSlots],
    float gi_out[kSlots], float dg_out[kSlots], float tr_out[kSlots],
    float vary = 0.f, float wscale = 1.f) {
  static_assert(!GUARD || MI == 4 || MI == 6, "the guard is for BayesC and BayesR");
  constexpr int R = row_stride(MI, NF, GUARD);
  const int lane = threadIdx.x % kWarp;
  float v = __shfl_sync(0xffffffffu, r[0], 0);  // r_local[0]
  float dg_prev = 0.f;
  int nrej = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll 8
    for (int jj = 0; jj < kWarp; ++jj) {
      const int j = s * kWarp + jj;
      if (j >= B) break;  // uniform across the warp
      const float* p = Ps + j * R;
      const float* wrow = Ws + j * B;
      const float w_prev = j > 0 ? (SCALE ? wscale * wrow[j - 1] : wrow[j - 1]) : 0.f;
      const float rhs = (j > 0 ? v + dg_prev * w_prev : v) + p[0];
      float v_next;
      if (jj + 1 < kWarp)
        v_next = __shfl_sync(0xffffffffu, r[s], jj + 1);
      else
        v_next = __shfl_sync(0xffffffffu, r[s + 1 < kSlots ? s + 1 : s], 0);
      float tr;
      float gi = draw_one<MI, NF>(p, rhs, &tr);
      if constexpr (GUARD) nrej += guard_draw<MI, NF>(p, rhs, tr, vary, &gi);
      const float dg = p[1] - gi;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int i = lane + kWarp * t;
        if (i < B) r[t] += dg * (SCALE ? wscale * wrow[i] : wrow[i]);
      }
      if (lane == jj) {
        gi_out[s] = gi;
        dg_out[s] = dg;
        tr_out[s] = tr;
      }
      v = v_next;
      dg_prev = dg;
    }
  }
  return nrej;
}

}  // namespace hb

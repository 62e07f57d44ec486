// Hopper kernel of the single-step (ssbrm) epsilon sweep.
//
// Built with nvcc into its own shared library with a plain C interface
// (hibayes_tpu_torch/ops/build.py) and called through ctypes
// (hibayes_tpu_torch/ops/blockgibbs.py:mme_sweep).  The entry points return
// cudaGetLastError(); the Python wrapper raises when it is not 0.
//
// It replaces the TPU kernel of hibayes_tpu/ops/blockgibbs.py:
//   hb_mme_sweep <- _kernel_mme_block / mme_block_draws   (:1805-1847)
// together with the XLA scan around it in blocked_mme_gibbs_sparse
// (hibayes_tpu/engine/gibbs.py:610-644).  The TPU kernel draws the T sites
// of one diagonal block of LHS = scale * A + diag(counts),
//
//   dx_j = (r_j - sum_{i<j} Wb[j, i] dx_i) * invd_j + noise_j,
//
// with invd = 1 / diag(Wb) and noise = sqrt(ve / diag(Wb)) z (both 0 where
// diag(Wb) <= 0: padded sites stay frozen), and XLA then scatters the
// block's forward triplets of A into the residual, res[row] -= scale *
// A[row, col] dx[col], before the next block.  One TPU launch per block,
// 1,250 per sweep at qe = 80,000 and T = 64.
//
// What bounds it on this card: latency, not memory.  A sweep moves about
// 23 MB (7 us at 3.35 TB/s), but its qe draws are one dependent chain.  So
// the whole sweep is one launch of one CTA that walks the blocks in order,
// and everything but the chain is taken off it.  Phase t (one
// __syncthreads at its end) runs, side by side:
//   warp 0, the drawer: block t's T draws (mme_chain: lane l owns sites
//     S l .. S l + S - 1, S = TM / 32; the rhs of draw j is shuffled from
//     its owner three draws ahead, before dx_{j-2} and dx_{j-1} are folded
//     in, and every lane subtracts Wb[j, j-2] dx_{j-2} and Wb[j, j-1]
//     dx_{j-1} itself, so no shuffle and no shared load waits between two
//     draws); then the block's terms to rows of block t + 1, summed from
//     the staged record, which it subtracts from block t + 1's residual
//     when phase t + 1 begins;
//   warp 1, the loader: the copy engine brings block t + 2's transposed
//     diagonal block and record into a ring of three shared-memory slots
//     (cp.async.bulk), cp.async its counts and z; block t + 1's slot, landed
//     a phase ago, is turned into scale Wb and per-site [invd, noise,
//     Wb[j, j-1], Wb[j, j-2]];
//   warp 2: x_out and the final residual of block t - 1 (the drawer
//     stores nothing itself);
//   warp 3: block t + 1's residual from global memory into shared memory,
//     and (after a named barrier with the scatter warps) block t - 1's
//     terms to rows of block t + 1 into it;
//   warps 4-7, the scatter: block t - 1's other terms, each row's sum in
//     stored order, to rows two blocks on (into shared memory, above) or
//     further (res in global memory; each row has one thread, and its
//     blocks come in sweep order, one a phase: no atomics); a thread's
//     first row of block t and its first entries are read at the end of
//     phase t, so that phase t + 1 waits on its residual alone.
// The split of each block's rows by target block, the transposed diagonal
// blocks and the per-block records come from a plan the host builds once
// per layout (ops/blockgibbs.py:mme_plan).  Every input is prefetched into
// L2 when the sweep starts.
//
// A batch of K chains is one launch of K CTAs, CTA k running the program
// above on chain k's z, x, res, scale and ve.  The plan (Dt, rec,
// far_rows, ent) and counts are shared and read-only; CTA 0 alone
// prefetches them into L2.  The sweep is latency-bound, so each chain
// keeps its own SM (one CTA an SM: K <= 132 chains run side by side at
// about one chain's time, more run in waves); no CTA waits on another.
//
// Rounding: each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no fused multiply-add), with the operands and in the order of
// the plain version (ops/blockgibbs.py:mme_sweep_plain) and of the
// single-CTA kernel this replaced: a site's residual takes its terms draw
// by draw, a row's scatter sum its entries in stored order and its blocks
// in sweep order, so x_new and res are bit for bit that kernel's, and
// chain k of a K-chain launch is bit for bit a one-chain launch on chain
// k's inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"

namespace hb {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;              // sites per diagonal block (4 per lane)
constexpr int kThreads = 256;
constexpr int kSlots = 3;               // block slots in flight: drawn, prepared, landing
constexpr int kLoaderWarp = 1;
constexpr int kXWarp = 2;
constexpr int kResWarp = 3;
constexpr int kScatterWarp = 4;         // warps 4-7
constexpr int kScatterThreads = kThreads - kScatterWarp * kWarp;
constexpr int kScatterBar = 1;          // named barrier: the scatter warps and warp 3
constexpr int kRecHead = 8;             // ints of a record before its row pointers
constexpr int kStamps = 6;              // stamps a phase
constexpr int kPfEnt = 4;               // entries of a scatter row read a phase ahead
constexpr unsigned kFull = 0xffffffffu;

// Launches of the sweep kernel, counted where it is launched (hb_mme_launch_counts).
long long g_mme_sweep = 0;

// A block's record (ints, built by mme_plan): [0] fr0, [1] fr1: its rows
// far_rows[fr0 .. fr1) for the scatter; [4 .. 8) a mask of the rows of
// block i + 2 among them (bit k: row k of that block); [kRecHead ..
// kRecHead + TM + 1) nptr: the terms to row k of block i + 1 are entries
// nptr[k] .. nptr[k + 1) of the (column, value) pairs from near_ent(TM).
__host__ __device__ constexpr int near_ent(int TM) { return kRecHead + ((TM + 1 + 3) & ~3); }

struct MmeArgs {
  const float* Dt;       // (nbr, TM, TM): Dt[i][j][k] = A_ii[k, j], zero past T
  const int* rec;        // (nbr, RI) block records
  const int4* far_rows;  // (row, e0, e1, its block if two on, else -1) of the scatter
  const int2* ent;       // (column in block, value bits) of every triplet
  const float* counts;
  const float* z;
  const float* x_in;
  float* x_out;
  float* res;
  const float* scale_p;  // one a chain
  const float* ve_p;     // one a chain
  long long res_len, n_far, n_ent;
  int nbr, T, RI;
  long long* stamps;     // measurement only (null in use)
};

// Chain k's arguments: its z, x_in, x_out (nbr T each), res (res_len),
// scale and ve; chain 0 alone keeps the stamps.
__device__ __forceinline__ MmeArgs chain_args(MmeArgs a, int k) {
  const long long q = static_cast<long long>(a.nbr) * a.T;
  a.z += k * q;
  a.x_in += k * q;
  a.x_out += k * q;
  a.res += k * a.res_len;
  a.scale_p += k;
  a.ve_p += k;
  if (k != 0) a.stamps = nullptr;
  return a;
}

// Shared memory of one slot in floats: the block (TM x TM), the per-site
// constants (TM float4), the record, counts and z.
__host__ __device__ inline int slot_floats(int TM, int RI) {
  return TM * TM + 4 * TM + RI + 2 * TM;
}

// The whole CTA's shared memory in floats: the three mbarriers (8 floats),
// three slots, the next two blocks' residuals, two blocks' dx, the terms
// to rows two blocks on, two blocks' final residuals, and a ring of four
// records' heads.
__host__ __device__ inline int mme_smem_floats(int TM, int RI) {
  return 8 + kSlots * slot_floats(TM, RI) + 2 * TM + 2 * TM + TM + 2 * TM + 4 * 8;
}

template <int N>
struct VecOf;
template <>
struct VecOf<1> { using T = float; };
template <>
struct VecOf<2> { using T = float2; };
template <>
struct VecOf<4> { using T = float4; };

template <int S>
__device__ __forceinline__ void load_vec(const float* p, float w[S]) {
  const auto v = *reinterpret_cast<const typename VecOf<S>::T*>(p);
  if constexpr (S == 1) {
    w[0] = v;
  } else if constexpr (S == 2) {
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

// The TM sequential draws of one block, run by one whole warp.
//   Wt  (TM, TM) in shared memory, Wt[j * TM + k] = Wb[k, j] (scaled; zero
//       past T)
//   cs  per site j: (invd_j, noise_j, Wb[j, j - 1], Wb[j, j - 2]), zero past T
//   r   in: the residual of sites S lane + s; clobbered
//   dxo out: dx of sites S lane + s
// Draw j folds dx_j into every lane's residuals at once (r_k -= Wb[k, j]
// dx_j).  The residual that draw j + 3 starts from is shuffled from its
// owner right after that fold, so it lacks the folds of draws j + 1 and
// j + 2: every lane subtracts those two itself, in that order, with the
// same operands, so each rhs is bit for bit the owner's own value.  The
// per-site constants and the block's rows are read two draws ahead.
template <int TM>
__device__ __forceinline__ void mme_chain(const float* __restrict__ Wt,
                                          const float4* __restrict__ cs,
                                          float r[TM / kWarp], float dxo[TM / kWarp]) {
  constexpr int S = TM / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = S * lane;
  float v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = __shfl_sync(kFull, r[j % S], j / S);
  float4 cq[2];
  float wq[2][S];
  cq[0] = cs[0];
  cq[1] = cs[1];
  load_vec<S>(Wt + c0, wq[0]);
  load_vec<S>(Wt + TM + c0, wq[1]);
  float dm1 = 0.f, dm2 = 0.f;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int q = j & 1;
    const float4 c = cq[q];
    float w[S];
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = wq[q][s];
    if (j + 2 < TM) {
      cq[q] = cs[j + 2];
      load_vec<S>(Wt + (j + 2) * TM + c0, wq[q]);
    }
    const float x = __fsub_rn(v[j % 3], __fmul_rn(c.w, dm2));
    const float rhs = __fsub_rn(x, __fmul_rn(c.z, dm1));
    const float d = __fadd_rn(__fmul_rn(rhs, c.x), c.y);
#pragma unroll
    for (int s = 0; s < S; ++s) r[s] = __fsub_rn(r[s], __fmul_rn(w[s], d));
    if (j + 3 < TM) v[j % 3] = __shfl_sync(kFull, r[(j + 3) % S], (j + 3) / S);
    if (lane == j / S) dxo[j % S] = d;
    dm2 = dm1;
    dm1 = d;
  }
}

// One warp turns a landed slot into the chain's inputs: per site j < T the
// constants (invd_j, noise_j, Wb[j, j - 1], Wb[j, j - 2]) from the raw
// block, its counts and z (zero past T), then the block itself scaled in
// place (Wb off the diagonal; the chain never reads a site's own residual
// after its draw, so the diagonal's counts are left out).
__device__ __forceinline__ void prepare_block(float* Wt, float4* cs, const float* cnt,
                                              const float* zz, float scale, float ve, int TM,
                                              int T) {
  const int lane = threadIdx.x % kWarp;
  for (int j = lane; j < TM; j += kWarp) {
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < T) {
      const float d = __fadd_rn(__fmul_rn(scale, Wt[j * TM + j]), cnt[j]);
      const bool ok = d > 0.f;
      c.x = ok ? __fdiv_rn(1.f, d) : 0.f;
      c.y = ok ? __fmul_rn(__fsqrt_rn(__fdiv_rn(ve, d)), zz[j]) : 0.f;
      c.z = j >= 1 ? __fmul_rn(scale, Wt[(j - 1) * TM + j]) : 0.f;
      c.w = j >= 2 ? __fmul_rn(scale, Wt[(j - 2) * TM + j]) : 0.f;
    }
    cs[j] = c;
  }
  __syncwarp();
  float4* W4 = reinterpret_cast<float4*>(Wt);
  for (int e = lane; e < TM * TM / 4; e += kWarp) {
    float4 w = W4[e];
    w.x = __fmul_rn(scale, w.x); w.y = __fmul_rn(scale, w.y);
    w.z = __fmul_rn(scale, w.z); w.w = __fmul_rn(scale, w.w);
    W4[e] = w;
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 1) mme_sweep_kernel(MmeArgs args) {
  constexpr int S = TM / kWarp;
  const MmeArgs a = chain_args(args, blockIdx.x);
  const bool shared_pf = blockIdx.x == 0;   // the one CTA that prefetches the plan
  extern __shared__ __align__(16) float sm[];
  const int T = a.T, nbr = a.nbr, RI = a.RI;
  const int SF = slot_floats(TM, a.RI);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  // slots are addressed by offsets from the shared array (never a table of
  // pointers), so their loads stay shared-memory loads
  float* slot0 = sm + 8;
  auto Wt = [&](int b) { return slot0 + (b % kSlots) * SF; };
  auto cs = [&](int b) { return reinterpret_cast<float4*>(Wt(b) + TM * TM); };
  auto recp = [&](int b) { return reinterpret_cast<int*>(Wt(b) + TM * TM + 4 * TM); };
  auto cnt = [&](int b) { return Wt(b) + TM * TM + 4 * TM + RI; };
  auto zz = [&](int b) { return cnt(b) + TM; };
  float* rnext = slot0 + kSlots * SF;     // [2][TM]
  float* dxs = rnext + 2 * TM;            // [2][TM]
  float* d2acc = dxs + 2 * TM;            // [TM]
  float* rfin = d2acc + TM;               // [2][TM]
  int* hring = reinterpret_cast<int*>(rfin + 2 * TM);   // [4][8]
  const float scale = *a.scale_p, ve = *a.ve_p;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  long long* st = a.stamps;
  const unsigned block_bytes = static_cast<unsigned>(sizeof(float)) * TM * TM;
  const unsigned rec_bytes = static_cast<unsigned>(sizeof(int)) * RI;

  // the loader: block b's copies into its slot (one commit group a call)
  auto issue = [&](int b) {
    if (b < nbr) {
      if (lane == 0) {
        fence_async();
        uint64_t* bb = bar + b % kSlots;
        mbar_expect(bb, block_bytes + rec_bytes);
        bulk_copy(Wt(b), a.Dt + static_cast<long long>(b) * TM * TM, block_bytes, bb);
        bulk_copy(recp(b), a.rec + static_cast<long long>(b) * RI, rec_bytes, bb);
      }
      const long long c0 = static_cast<long long>(b) * T;
      for (int j = lane; j < T; j += kWarp) {
        cp_async4(cnt(b) + j, a.counts + c0 + j);
        cp_async4(zz(b) + j, a.z + c0 + j);
      }
    }
    cp_async_commit();
  };
  // the loader: block b's copies (issued a phase before) have landed; make
  // its slot the chain's inputs and keep its record's head
  auto prepare = [&](int b) {
    if (b >= nbr) return;
    mbar_wait(bar + b % kSlots, (b / kSlots) & 1);
    cp_async_wait<1>();
    __syncwarp();
    if (lane < 8) hring[(b & 3) * 8 + lane] = recp(b)[lane];
    prepare_block(Wt(b), cs(b), cnt(b), zz(b), scale, ve, TM, T);
  };

  if (tid == 0) {
    for (int q = 0; q < kSlots; ++q) mbar_init(bar + q);
    if (st != nullptr) {
      st[kStamps * (nbr + 1)] = global_ns();
      st[kStamps * (nbr + 1) + 2] = clock64();
    }
  }
  __syncthreads();
  if (warp == kLoaderWarp) {
    issue(0);
    issue(1);
    if (lane == 0) {
      prefetch_l2(a.res, 4 * a.res_len);
      if (shared_pf) {
        prefetch_l2(a.Dt, 4LL * nbr * TM * TM);
        prefetch_l2(a.far_rows, 16 * a.n_far);
        prefetch_l2(a.ent, 8 * a.n_ent);
        prefetch_l2(a.rec, 4LL * nbr * RI);
        prefetch_l2(a.counts, 4LL * nbr * T);
      }
      prefetch_l2(a.x_in, 4LL * nbr * T);
      prefetch_l2(a.z, 4LL * nbr * T);
    }
    prepare(0);
  } else if (warp == kResWarp) {
    for (int k = lane; k < TM; k += kWarp) rnext[k] = k < T ? __ldcg(a.res + k) : 0.f;
  }
  __syncthreads();

  float acc[S];      // the drawer: block t - 1's terms to its sites of block t
  int has[S];
  int4 pf_row = make_int4(0, 0, 0, -1);   // the scatter: the next phase's first row
  int2 pf_ent[kPfEnt];
#pragma unroll
  for (int i = 0; i < kPfEnt; ++i) pf_ent[i] = make_int2(0, 0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    acc[s] = 0.f;
    has[s] = 0;
  }
  for (int t = 0; t <= nbr; ++t) {
    if (warp == 0) {
      if (t < nbr) {
        const int c0 = S * lane;
        float r[S], dxo[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int k = c0 + s;
          r[s] = rnext[(t & 1) * TM + k];
          if (has[s]) r[s] = __fsub_rn(r[s], __fmul_rn(scale, acc[s]));
          rfin[(t & 1) * TM + k] = r[s];   // the block's final residual, stored by warp 2
          dxo[s] = 0.f;
        }
        if (st != nullptr && lane == 0) st[kStamps * t] = clock64();
        mme_chain<TM>(Wt(t), cs(t), r, dxo);
        float* dx = dxs + (t & 1) * TM;
#pragma unroll
        for (int s = 0; s < S; ++s) dx[c0 + s] = dxo[s];
        __syncwarp();
        if (st != nullptr && lane == 0) st[kStamps * t + 1] = clock64();
        // block t's terms to rows of block t + 1, each in stored order
        const int* rc = recp(t);
        const int2* ne = reinterpret_cast<const int2*>(rc + near_ent(TM));
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int k = c0 + s;
          const int e0 = rc[kRecHead + k], e1 = rc[kRecHead + k + 1];
          float sacc = 0.f;
          for (int e = e0; e < e1; ++e) {
            const int2 en = ne[e];
            sacc = __fadd_rn(sacc, __fmul_rn(__int_as_float(en.y), dx[en.x]));
          }
          acc[s] = sacc;
          has[s] = e1 > e0;
        }
        if (st != nullptr && lane == 0) st[kStamps * t + 2] = clock64();
      }
    } else if (warp == kLoaderWarp) {
      issue(t + 2);
      prepare(t + 1);
      if (st != nullptr && lane == 0 && t < nbr) st[kStamps * t + 5] = clock64();
    } else if (warp == kXWarp) {
      if (t >= 1) {
        const long long k0 = static_cast<long long>(t - 1) * T;
        const float* dx = dxs + ((t - 1) & 1) * TM;
        const float* rf = rfin + ((t - 1) & 1) * TM;
        for (int k = lane; k < T; k += kWarp) {
          a.x_out[k0 + k] = __fadd_rn(a.x_in[k0 + k], dx[k]);
          __stcg(a.res + k0 + k, rf[k]);
        }
      }
    } else if (warp == kResWarp) {
      float* rn = rnext + ((t + 1) & 1) * TM;
      if (t + 1 < nbr) {
        float v[TM / kWarp];   // every load in flight before the first store
#pragma unroll
        for (int s = 0; s < TM / kWarp; ++s) {
          const int k = lane + kWarp * s;
          v[s] = k < T ? __ldcg(a.res + static_cast<long long>(t + 1) * T + k) : 0.f;
        }
#pragma unroll
        for (int s = 0; s < TM / kWarp; ++s) rn[lane + kWarp * s] = v[s];
      }
      if (t >= 1) {
        bar_sync(kScatterBar, kWarp + kScatterThreads);
        if (t + 1 < nbr) {
          const int* mask = hring + ((t - 1) & 3) * 8 + 4;
          for (int k = lane; k < TM; k += kWarp)
            if ((mask[k / 32] >> (k % 32)) & 1)
              rn[k] = __fsub_rn(rn[k], __fmul_rn(scale, d2acc[k]));
        }
      }
      if (st != nullptr && lane == 0 && t < nbr) st[kStamps * t + 4] = clock64();
    } else if (warp >= kScatterWarp) {
      const int ts = tid - kScatterWarp * kWarp;
      if (t >= 1) {
        const int b = t - 1;
        const int* h = hring + (b & 3) * 8;
        const float* dx = dxs + (b & 1) * TM;
        for (int u = h[0] + ts; u < h[1]; u += kScatterThreads) {
          const bool first = u == h[0] + ts;
          const int4 fr = first ? pf_row : __ldg(a.far_rows + u);   // row, e0, e1, its block
          const bool two = fr.w >= 0;   // a row of block b + 2
          const float rv = two ? 0.f : __ldcg(a.res + fr.x);
          float sacc = 0.f;
#pragma unroll
          for (int i = 0; i < kPfEnt; ++i) {
            if (fr.y + i < fr.z) {
              const int2 en = first ? pf_ent[i] : __ldg(a.ent + fr.y + i);
              sacc = __fadd_rn(sacc, __fmul_rn(__int_as_float(en.y), dx[en.x]));
            }
          }
          for (int e = fr.y + kPfEnt; e < fr.z; ++e) {
            const int2 en = __ldg(a.ent + e);
            sacc = __fadd_rn(sacc, __fmul_rn(__int_as_float(en.y), dx[en.x]));
          }
          if (two) d2acc[fr.x - fr.w * T] = sacc;
          else __stcg(a.res + fr.x, __fsub_rn(rv, __fmul_rn(scale, sacc)));
        }
        bar_arrive(kScatterBar, kWarp + kScatterThreads);
        if (st != nullptr && ts == 0) st[kStamps * b + 3] = clock64();
      }
      // block t's first row of this thread and its first entries, read now
      // so that the next phase waits on one load (of res) for it, not three
      if (t < nbr) {
        const int* hn = hring + (t & 3) * 8;
        const int u = hn[0] + ts;
        if (u < hn[1]) {
          pf_row = __ldg(a.far_rows + u);
#pragma unroll
          for (int i = 0; i < kPfEnt; ++i)
            if (pf_row.y + i < pf_row.z) pf_ent[i] = __ldg(a.ent + pf_row.y + i);
        }
      }
    }
    __syncthreads();
  }
  if (st != nullptr && tid == 0) {
    st[kStamps * (nbr + 1) + 1] = global_ns();
    st[kStamps * (nbr + 1) + 3] = clock64();
  }
}

// The epsilon chain alone (measurement): block W (T, T) row-major staged
// as the sweep stages it, then one warp runs `reps` chains back to back,
// each from r0 and depending on the one before.  cycles gets the chains'
// clock64 cycles; out (T) the last chain's dx (kept live).
template <int TM>
__global__ void __launch_bounds__(kThreads, 1)
mme_chain_kernel(const float* __restrict__ W, const float* __restrict__ counts,
                 const float* __restrict__ z, const float* __restrict__ scale_p,
                 const float* __restrict__ ve_p, const float* __restrict__ r0, int T,
                 int reps, float* __restrict__ out, long long* cycles) {
  constexpr int S = TM / kWarp;
  extern __shared__ __align__(16) float sm[];
  float* Wt = sm;
  float4* cs = reinterpret_cast<float4*>(Wt + TM * TM);
  float* cnt = Wt + TM * TM + 4 * TM;
  float* zz = cnt + TM;
  for (int e = threadIdx.x; e < TM * TM; e += blockDim.x) {
    const int j = e / TM, k = e - j * TM;
    Wt[e] = (j < T && k < T) ? W[k * T + j] : 0.f;
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    cnt[j] = counts[j];
    zz[j] = z[j];
  }
  __syncthreads();
  if (threadIdx.x >= kWarp) return;
  prepare_block(Wt, cs, cnt, zz, *scale_p, *ve_p, TM, T);
  __syncwarp();
  const int c0 = S * threadIdx.x;
  float r0v[S], r[S], dxo[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r0v[s] = c0 + s < T ? r0[c0 + s] : 0.f;
    dxo[s] = 0.f;
  }
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < S; ++s) r[s] = r0v[s] + 0.f * dxo[s];
    mme_chain<TM>(Wt, cs, r, dxo);
  }
  const long long t1 = clock64();
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (c0 + s < T) out[c0 + s] = dxo[s];
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

inline int tile_of(int T) { return T <= 32 ? 32 : (T <= 64 ? 64 : 128); }

template <int TM>
cudaError_t sweep_tm(const MmeArgs& a, int chains, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(mme_smem_floats(TM, a.RI));
  cudaError_t e = cudaFuncSetAttribute(mme_sweep_kernel<TM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  mme_sweep_kernel<TM><<<chains, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int TM>
cudaError_t chain_tm(const float* W, const float* counts, const float* z, const float* scale,
                     const float* ve, const float* r0, int T, int reps, float* out,
                     long long* cycles, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(TM * TM + 6 * TM);
  cudaError_t e = cudaFuncSetAttribute(mme_chain_kernel<TM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  mme_chain_kernel<TM><<<1, kThreads, smem, stream>>>(W, counts, z, scale, ve, r0, T, reps,
                                                      out, cycles);
  return cudaGetLastError();
}

}  // namespace hb

extern "C" {

const char* hb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches since the last reset.
void hb_mme_launch_counts(long long* out) { out[0] = hb::g_mme_sweep; }

void hb_mme_reset_launch_counts() { hb::g_mme_sweep = 0; }

// Shared memory bytes of a sweep over blocks of T sites with records of RI
// ints (the plan's check before a launch).
long long hb_mme_smem_bytes(int T, int RI) {
  return static_cast<long long>(sizeof(float)) * hb::mme_smem_floats(hb::tile_of(T), RI);
}

// Sweep diagonal blocks 0 .. nbr - 1 of the epsilon system in order for
// `chains` chains, in one launch (a CTA a chain).  Dt (nbr, TM, TM) the
// transposed diagonal blocks of A, zero past T (TM = 32, 64 or 128, the
// least >= T); rec (nbr, RI) the blocks' records; far_rows (n_far, 4) and
// ent (n_ent, 2) the scatter's rows and every triplet's (column, value
// bits) (all from the plan, ops/blockgibbs.py:mme_plan); counts (nbr T,),
// shared; per chain: z, x_in, x_out (chains, nbr T); res (chains, res_len)
// the residual b - LHS x, updated in place; scale, ve (chains,) on the
// device.  stamps (measurement only; null in use; chain 0's): 6 clock64
// values a phase (nbr + 1 phases: the chain's start and end, the drawer's
// end, the scatter's, warp 3's and the loader's), then %globaltimer ns and
// clock64 at the sweep's start and end.
int hb_mme_sweep(const float* Dt, const int* rec, const int* far_rows, const int* ent,
                 const float* counts, const float* scale, const float* ve, const float* z,
                 const float* x_in, float* x_out, float* res, long long res_len,
                 long long n_far, long long n_ent, int nbr, int T, int RI, int chains,
                 long long* stamps, void* stream) {
  if (T < 1 || T > hb::kMaxT || nbr < 1 || RI < hb::near_ent(hb::tile_of(T)) || RI % 4 != 0 ||
      res_len < static_cast<long long>(nbr) * T || chains < 1)
    return cudaErrorInvalidValue;
  const hb::MmeArgs a{Dt, rec, reinterpret_cast<const int4*>(far_rows),
                      reinterpret_cast<const int2*>(ent), counts, z, x_in, x_out, res,
                      scale, ve, res_len, n_far, n_ent, nbr, T, RI, stamps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hb::tile_of(T)) {
    case 32: e = hb::sweep_tm<32>(a, chains, s); break;
    case 64: e = hb::sweep_tm<64>(a, chains, s); break;
    default: e = hb::sweep_tm<128>(a, chains, s); break;
  }
  if (e == cudaSuccess) ++hb::g_mme_sweep;
  return e;
}

// The epsilon chain alone (measurement): reps chains of one block W (T, T)
// back to back in one warp; cycles gets their clock64 cycles.
int hb_mme_chain_latency(const float* W, const float* counts, const float* z,
                         const float* scale, const float* ve, const float* r0, int T, int reps,
                         float* out, long long* cycles, void* stream) {
  if (T < 1 || T > hb::kMaxT || reps < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hb::tile_of(T)) {
    case 32: return hb::chain_tm<32>(W, counts, z, scale, ve, r0, T, reps, out, cycles, s);
    case 64: return hb::chain_tm<64>(W, counts, z, scale, ve, r0, T, reps, out, cycles, s);
    default: return hb::chain_tm<128>(W, counts, z, scale, ve, r0, T, reps, out, cycles, s);
  }
}

}  // extern "C"

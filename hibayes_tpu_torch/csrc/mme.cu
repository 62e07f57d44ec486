// Hopper kernel of the single-step (ssbrm) epsilon sweep.
//
// Built with nvcc into its own shared library with a plain C interface
// (hibayes_tpu_torch/ops/build.py) and called through ctypes
// (hibayes_tpu_torch/ops/blockgibbs.py:mme_sweep).  The entry point returns
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
// Here the whole sweep is one launch of one CTA that walks the blocks in
// order, because block i + 1 reads the residual block i's scatter wrote:
//   1. warp 0 reads the block's residual and makes the T dependent draws:
//      lane l holds r[l + 32 s] in registers; draw j takes r_j with one
//      shuffle from its lane, every lane evaluates dx_j, then subtracts
//      Wb[:, j] dx_j from its r, reading a conflict-free row of the
//      transposed block in shared memory (row stride T + 1);
//   2. meanwhile warps 1-7 load the next block into the other of two
//      shared-memory buffers: Wb = scale * Wd + diag(counts) transposed,
//      invd and noise;
//   3. after a barrier every thread applies the block's triplets, grouped
//      by target row: thread t owns distinct rows, sums its row's terms in
//      stored order and subtracts scale * sum once.  No two threads write
//      one row and nothing is atomic, so a chain is bit-reproducible.
// The residual (qe_pad floats, 320 KB at qe = 80,000) stays in L2.
//
// What bounds it on this card: latency, not memory.  A sweep moves about
// 23 MB (the 1,250 diagonal blocks of 16 KB and the triplets; 7 us at
// 3.35 TB/s), but the qe draws are one dependent chain: each costs a
// shuffle and a shared-memory load, and each block adds two barriers and
// the scatter.  The design keeps the chain in one warp and hides the next
// block's loads behind it.
//
// Rounding: each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no fused multiply-add), in the order of the plain version
// (ops/blockgibbs.py:mme_sweep_plain), so the draws repeat its float32
// arithmetic; the scatter sums a row's terms in stored order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace hb {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;              // sites per diagonal block (4 per lane)
constexpr int kSlots = kMaxT / kWarp;
constexpr int kThreads = 256;           // warp 0 draws; warps 1-7 load ahead
constexpr unsigned kFull = 0xffffffffu;

// Launches of the sweep kernel, counted where it is launched (hb_mme_launch_counts).
long long g_mme_sweep = 0;

// Floats of one shared-memory buffer: the transposed block (T x (T + 1)),
// invd (T) and noise (T).
__host__ __device__ inline int buffer_floats(int T) { return T * (T + 1) + 2 * T; }

// Block i into buf, by threads t0, t0 + nt, ...: buf[c (T + 1) + k] =
// Wb[k, c] with Wb = scale * Wd[i] + diag(counts), then invd and noise.
__device__ __forceinline__ void load_block(
    const float* __restrict__ Wd, const float* __restrict__ counts,
    const float* __restrict__ z, float scale, float ve, int i, int T,
    float* __restrict__ buf, int t0, int nt) {
  const int ld = T + 1;
  const float* W = Wd + static_cast<long long>(i) * T * T;
  const long long c0 = static_cast<long long>(i) * T;
  for (int e = t0; e < T * T; e += nt) {
    const int k = e / T, c = e - k * T;
    float w = __fmul_rn(scale, W[e]);
    if (k == c) w = __fadd_rn(w, counts[c0 + k]);
    buf[c * ld + k] = w;
  }
  float* invd = buf + T * ld;
  float* noise = invd + T;
  for (int j = t0; j < T; j += nt) {
    const float d = __fadd_rn(__fmul_rn(scale, W[j * T + j]), counts[c0 + j]);
    const bool ok = d > 0.f;
    invd[j] = ok ? __fdiv_rn(1.f, d) : 0.f;
    noise[j] = ok ? __fmul_rn(__fsqrt_rn(__fdiv_rn(ve, d)), z[c0 + j]) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
mme_sweep_kernel(const float* __restrict__ Wd, const float* __restrict__ counts,
                 const float* __restrict__ scale_p, const float* __restrict__ ve_p,
                 const float* __restrict__ z, const float* __restrict__ x_in,
                 float* __restrict__ x_out, float* __restrict__ res,
                 const int* __restrict__ blk_ptr, const int* __restrict__ urow,
                 const int* __restrict__ row_ptr, const int* __restrict__ ent_col,
                 const float* __restrict__ ent_val, int nbr, int T) {
  extern __shared__ float smem[];
  const int ld = T + 1;
  const int bf = buffer_floats(T);
  float* dxs = smem + 2 * bf;           // the current block's dx (T)
  const float scale = *scale_p, ve = *ve_p;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;

  load_block(Wd, counts, z, scale, ve, 0, T, smem, tid, kThreads);
  __syncthreads();
  for (int i = 0; i < nbr; ++i) {
    const long long c0 = static_cast<long long>(i) * T;
    const float* buf = smem + (i & 1) * bf;
    if (warp == 0) {
      const float* invd = buf + T * ld;
      const float* noise = invd + T;
      float r[kSlots], dx[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = lane + kWarp * s;
        r[s] = k < T ? res[c0 + k] : 0.f;
        dx[s] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        for (int jj = 0; jj < kWarp; ++jj) {
          const int j = kWarp * s + jj;
          if (j >= T) break;            // uniform across the warp
          const float rj = __shfl_sync(kFull, r[s], jj);
          const float d = __fadd_rn(__fmul_rn(rj, invd[j]), noise[j]);
          if (lane == jj) dx[s] = d;
          const float* col = buf + j * ld;   // Wb[:, j]
#pragma unroll
          for (int s2 = 0; s2 < kSlots; ++s2) {
            const int k = lane + kWarp * s2;
            if (k < T) r[s2] = __fsub_rn(r[s2], __fmul_rn(col[k], d));
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = lane + kWarp * s;
        if (k < T) {
          dxs[k] = dx[s];
          x_out[c0 + k] = __fadd_rn(x_in[c0 + k], dx[s]);
        }
      }
    } else if (i + 1 < nbr) {
      load_block(Wd, counts, z, scale, ve, i + 1, T, smem + ((i + 1) & 1) * bf,
                 tid - kWarp, kThreads - kWarp);
    }
    __syncthreads();                    // dx of block i and block i + 1's buffer ready
    for (int u = blk_ptr[i] + tid; u < blk_ptr[i + 1]; u += kThreads) {
      float acc = 0.f;
      for (int e = row_ptr[u]; e < row_ptr[u + 1]; ++e)
        acc = __fadd_rn(acc, __fmul_rn(ent_val[e], dxs[ent_col[e]]));
      const int row = urow[u];
      res[row] = __fsub_rn(res[row], __fmul_rn(scale, acc));
    }
    __syncthreads();                    // block i + 1 reads what the scatter wrote
  }
}

}  // namespace hb

extern "C" {

const char* hb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches since the last reset.
void hb_mme_launch_counts(long long* out) { out[0] = hb::g_mme_sweep; }

void hb_mme_reset_launch_counts() { hb::g_mme_sweep = 0; }

// Sweep diagonal blocks 0 .. nbr - 1 of the epsilon system in order.
// Wd (nbr, T, T) the blocks of A; counts, z, x_in, x_out (nbr T,); res
// (>= every triplet's row + 1,) the residual b - LHS x, updated in place;
// scale, ve one float each on the device.  The forward triplets of block i
// are grouped by target row: rows urow[blk_ptr[i] .. blk_ptr[i + 1]), row u's
// entries (in-block column, value) at row_ptr[u] .. row_ptr[u + 1].
int hb_mme_sweep(const float* Wd, const float* counts, const float* scale,
                 const float* ve, const float* z, const float* x_in, float* x_out,
                 float* res, const int* blk_ptr, const int* urow, const int* row_ptr,
                 const int* ent_col, const float* ent_val, int nbr, int T,
                 void* stream) {
  if (T < 1 || T > hb::kMaxT || nbr < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(hb::buffer_floats(T)) + T);
  cudaError_t e = cudaFuncSetAttribute(hb::mme_sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  hb::mme_sweep_kernel<<<1, hb::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Wd, counts, scale, ve, z, x_in, x_out, res, blk_ptr, urow, row_ptr, ent_col,
      ent_val, nbr, T);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++hb::g_mme_sweep;
  return e;
}

}  // extern "C"

// Microbenchmark: the epsilon chain (csrc/mme.cu mme_chain, T = 64) alone in
// one warp while the CTA's other seven warps are, in turn: gone (mode 0),
// waiting at a barrier (1), sleeping on a flag (2), reading shared memory
// (3), polling an mbarrier (4), loading from L2 (5), polling a flag with
// acquire loads and sleeps (6).  Prints clock64 cycles a draw for each.
// Build and run on the card from the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o mme_chain_neighbours scripts/mme_chain_neighbours.cu && ./mme_chain_neighbours
#include "../hibayes_tpu_torch/csrc/mme.cu"
#include <cstdio>
#include <vector>
namespace hb {
template <int MODE>
__global__ void __launch_bounds__(256, 1) bench(const float* W, const float* counts, const float* z, float scale, float ve, const float* r0, int T, int reps, float* out, long long* cycles, int* flag) {
  constexpr int TM = 64, S = 2;
  extern __shared__ __align__(16) float sm[];
  float* Wt = sm; float4* cs = reinterpret_cast<float4*>(Wt + TM * TM); float* cnt = Wt + TM * TM + 4 * TM; float* zz = cnt + TM;
  float* junk = zz + TM;   // 8 KB of scratch for the busy warps
  for (int e = threadIdx.x; e < TM * TM; e += blockDim.x) { const int j = e / TM, k = e % TM; Wt[e] = (j < T && k < T) ? W[k * T + j] : 0.f; }
  for (int j = threadIdx.x; j < T; j += blockDim.x) { cnt[j] = counts[j]; zz[j] = z[j]; }
  __syncthreads();
  if (threadIdx.x < 32) prepare_block(Wt, cs, cnt, zz, scale, ve, TM, T);
  __syncthreads();
  if (threadIdx.x >= 32) {
    if (MODE == 0) return;                        // exit
    if (MODE == 1) { __syncthreads(); return; }   // wait at a barrier
    if (MODE == 2) {                              // spin on a flag with sleeps
      while (atomicAdd(flag, 0) == 0) __nanosleep(200);
      return;
    }
    if (MODE == 4) {                              // mbarrier try_wait spin on a phase that never completes
      __shared__ uint64_t mb;
      if (threadIdx.x == 32) mbar_init(&mb);
      __syncwarp();
      while (atomicAdd(flag, 0) == 0) {
        unsigned ok;
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}" : "=r"(ok) : "r"(smem_addr(&mb)), "r"(0u) : "memory");
      }
      return;
    }
    if (MODE == 5) {                              // global loads from L2
      float acc = 0.f;
      while (atomicAdd(flag, 0) == 0) for (int e = threadIdx.x; e < 4096; e += 224) acc += __ldcg(W + (e % (T * T)));
      if (acc == 1.f) out[0] = acc;
      return;
    }
    if (MODE == 6) {                              // global acquire polling with sleeps (await)
      while (static_cast<int>(load_acquire(reinterpret_cast<unsigned*>(flag)) - 1u) < 0) __nanosleep(64);
      return;
    }
    if (MODE == 3) {                              // shared-memory work
      volatile float* j = junk;
      float acc = 0.f;
      while (atomicAdd(flag, 0) == 0) for (int e = threadIdx.x; e < 2048; e += 224) acc += j[e];
      if (acc == 1.f) out[0] = acc;
      return;
    }
  }
  const int c0 = S * threadIdx.x;
  float r0v[S], r[S], dxo[S];
  for (int s = 0; s < S; ++s) { r0v[s] = c0 + s < T ? r0[c0 + s] : 0.f; dxo[s] = 0.f; }
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    for (int s = 0; s < S; ++s) r[s] = r0v[s] + 0.f * dxo[s];
    mme_chain<TM>(Wt, cs, r, dxo);
  }
  const long long t1 = clock64();
  for (int s = 0; s < S; ++s) if (c0 + s < T) out[c0 + s] = dxo[s];
  if (threadIdx.x == 0) { *cycles = t1 - t0; atomicExch(flag, 1); }
  if (MODE == 1) __syncthreads();
}
}
int main() {
  const int T = 64, reps = 400;
  float *W, *c, *z, *r0, *out; long long* cyc; int* flag;
  cudaMalloc(&W, T * T * 4); cudaMalloc(&c, T * 4); cudaMalloc(&z, T * 4); cudaMalloc(&r0, T * 4); cudaMalloc(&out, T * 4);
  cudaMalloc(&cyc, 8); cudaMalloc(&flag, 4);
  std::vector<float> h(T * T);
  for (int i = 0; i < T * T; ++i) h[i] = (i % T == i / T) ? 3.f : ((i * 7919) % 13 == 0 ? -0.1f : 0.f);
  cudaMemcpy(W, h.data(), T * T * 4, cudaMemcpyHostToDevice);
  std::vector<float> v(T, 1.f); cudaMemcpy(c, v.data(), T * 4, cudaMemcpyHostToDevice); cudaMemcpy(z, v.data(), T * 4, cudaMemcpyHostToDevice); cudaMemcpy(r0, v.data(), T * 4, cudaMemcpyHostToDevice);
  const size_t smem = (64 * 64 + 6 * 64) * 4 + 8192;
#define RUN(M) { cudaMemset(flag, 0, 4); cudaFuncSetAttribute(hb::bench<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
    hb::bench<M><<<1, 256, smem>>>(W, c, z, 0.7f, 1.3f, r0, T, reps, out, cyc, flag); cudaDeviceSynchronize(); \
    long long cy; cudaMemcpy(&cy, cyc, 8, cudaMemcpyDeviceToHost); printf("mode %d: %.2f cycles a draw (%s)\n", M, cy / (double)reps / T, cudaGetErrorString(cudaGetLastError())); }
  RUN(0) RUN(1) RUN(2) RUN(3) RUN(4) RUN(5) RUN(6) RUN(0)
  return 0;
}

// Microbenchmark: how fast the segment sweep's row owners can stream a
// dense LD segment (m = 32,768, float32, 4.29 GB) column block by column
// block, with no draws, flags or sums: 128 CTAs of 8 warps, each warp 32
// rows, copies of 4 rows x (blocks of B columns, 1 or 2 blocks a run)
// through a ring of 8 cp.async units, with or without an L2 prefetch of
// each warp's rows S blocks ahead.  Prints ms a sweep and TB/s for each
// variant.  Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o ld_column_stream scripts/ld_column_stream.cu && ./ld_column_stream
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>
#include <vector>
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N> __device__ __forceinline__ void waitg() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }
__device__ __forceinline__ void pf(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}
constexpr int kRing = 8;
// each CTA owns rows [o*256, o*256+256), warp w rows w*32..; streams blocks of B cols, units of 4 rows x (UB blocks)
template <int UB>
__global__ void __launch_bounds__(256, 1) stream(const float* LD, long long mc, int B, int nb, int S, float* out) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long wrow0 = (long long)blockIdx.x * 256 + warp * 32;
  const int W = B * UB;               // floats a unit row
  float* ring = sm + warp * kRing * 4 * W;
  const int upb = 8;                  // units a (super) block: 32 rows / 4
  const int nsb = nb / UB;
  const long long total = (long long)nsb * upb;
  auto issue = [&](long long s) {
    if (s < total) {
      const long long sb = s / upb; const int g = s % upb;
      float* U = ring + (s % kRing) * 4 * W;
      for (int e = lane; e < 4 * W / 4; e += 32) {
        const int v = e / (W / 4), c = 4 * (e % (W / 4));
        cp_async16(U + v * W + c, LD + (wrow0 + g * 4 + v) * mc + sb * W + c);
      }
    }
    commit();
  };
  float acc = 0.f;
  for (long long s = 0; s < kRing - 1; ++s) issue(s);
  long long s = 0;
  for (int sb = 0; sb < nsb; ++sb) {
    if (S > 0 && lane == 0 && (sb * UB) % S == 0) {   // L2 prefetch of this warp's rows for blocks [sb*UB + 2S, +S)
      const long long b0 = (long long)sb * UB + 2 * S;
      if (b0 + S <= nb)
        for (int v = 0; v < 32; ++v) pf(LD + (wrow0 + v) * mc + b0 * B, 4 * B * S);
    }
    for (int g = 0; g < upb; ++g, ++s) {
      __syncwarp();
      issue(s + kRing - 1);
      waitg<kRing - 1>();
      __syncwarp();
      const float* U = ring + (s % kRing) * 4 * W;
      for (int e = 4 * lane; e < 4 * W; e += 32 * 4) {
        const float4 x = *reinterpret_cast<const float4*>(U + e);
        acc += x.x + x.y + x.z + x.w;
      }
    }
  }
  if (acc == 12345.f) out[0] = acc;
}
int main() {
  const long long mc = 32768;
  float* LD; cudaMalloc(&LD, mc * mc * 4); cudaMemset(LD, 0, mc * mc * 4);
  float* out; cudaMalloc(&out, 4);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  for (int B : {64, 128}) for (int UB : {1, 2}) for (int S : {0, 1, 2, 4}) {
    const int nb = mc / B;
    const size_t smem = 8 * kRing * 4 * B * UB * 4;
    if (smem > 227 * 1024) continue;
    auto k = UB == 1 ? stream<1> : stream<2>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k<<<128, 256, smem>>>(LD, mc, B, nb, S, out);
    cudaEventRecord(a);
    for (int r = 0; r < 3; ++r) k<<<128, 256, smem>>>(LD, mc, B, nb, S, out);
    cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b); ms /= 3;
    printf("B %d unit blocks %d L2 prefetch window %d: %.3f ms, %.3f TB/s, %s\n", B, UB, S, ms, mc * mc * 4 / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}

// Launch helpers shared by the sweep kernels: Hopper's programmatic
// dependent launch, asynchronous copies into shared memory, and the flags
// that order work between the CTAs of one persistent grid.
//
// Programmatic dependent launch: a kernel launched with `overlap` may start
// while the kernel before it on the stream still runs.  It first loads what
// no earlier launch of the sweep writes, then calls wait_previous()
// (griddepcontrol.wait: the kernel before it has finished and its writes are
// visible) before it reads that kernel's output.  release_next() lets the
// next launch of the stream start.  Every grid has at least one thread that
// waits, so a grid never finishes before the one it follows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hb {

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
cudaError_t launch(bool overlap, void (*kernel)(P...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = overlap ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Asynchronous copies global -> shared (cp.async): 4 bytes through L1,
// 16 bytes through L2 only.  Completion is tracked per commit group.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Bulk copies global -> shared by the Tensor Memory Accelerator
// (cp.async.bulk): one thread asks for a whole contiguous block, the copy
// engine moves it, and its bytes are counted against an mbarrier in shared
// memory, which completes one phase when they have all landed.  No other
// thread spends an instruction on it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: `bytes` of bulk copies follow against bar's current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned).  Shared
// memory that generic loads read before must be released to the copy
// engine first (fence_async).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Wait until bar has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Flags between the CTAs of one grid, at device scope.  A writer makes its
// data visible to the whole CTA's threads' stores first (__syncthreads, then
// one thread calls publish); a reader's one thread spins in await, then the
// CTA synchronises before it reads.  Data read after an await is read with
// __ldcg (L2, never a stale L1 line).  Values compare modulo 2^32, so a
// counter may run on across sweeps.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned* p, unsigned v) {
  __threadfence();
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p has reached `target` (modulo 2^32).  A wait of more than
// 10 s can only be a fault (a schedule that does not match the layout, or
// a CTA that is not resident): the kernel traps, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void await(const unsigned* p, unsigned target) {
  unsigned ns = 32;
  long long t0 = 0;
  while (static_cast<int>(load_acquire(p) - target) < 0) {
    __nanosleep(ns);
    if (ns < 256) {
      ns *= 2;
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000LL) {
      __trap();
    }
  }
  __threadfence();
}

}  // namespace hb
